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
serving (whose parameters require none) runs the plain loop.

``mesh`` (a ``torch.distributed`` ``DeviceMesh``, or None) lays the
step over a device mesh as the reference's ``mesh`` does: the tensors are
DTensors, and each point where the reference calls
``with_sharding_constraint`` redistributes to the same layout
(``parallel/sharding.constrain``) — the weights at use (``use_weight``),
the projections and attention heads, the residual stream (sequence
parallel where ``cfg.seq_parallel``), the embedding and the logits.
Between those points DTensor's op propagation picks each op's layout and
issues the collectives.
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
from repro_torch.models.layers import use_weight
from repro_torch.parallel import sharding as sh


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

def embedding(params, compute_dtype, mesh=None):
    """The embedding table cast for compute; on a mesh gathered over the
    FSDP axis at use and kept vocab-parallel over TP — transposed, the
    tied head's layout, so one gather serves both."""
    return use_weight(mesh, params["embed"], compute_dtype, ("model", None))


def embed_tokens(emb, tokens, mesh=None):
    """Rows ``tokens`` of the table ``emb`` (``embedding``); on a mesh
    batch over DP. Each device looks up the ids of its batch shard that
    fall in its vocab rows, zeros elsewhere, and a sum over the model
    axis completes every row (a vocab-parallel lookup)."""
    if mesh is None:
        return F.embedding(tokens, emb)
    dp = sh.dp_axes_of(mesh)
    tokens = sh.constrain(mesh, tokens, (dp,) + (None,) * (tokens.dim() - 1))
    tp = mesh.mesh_dim_names.index("model")
    # the gradient of this device's rows sums over the batch shards
    rows = emb.to_local(grad_placements=[
        sh.Partial() if t.is_shard() else e
        for t, e in zip(tokens.placements, emb.placements)])
    split = emb.placements[tp].is_shard()
    lo = sh.local_range(mesh, "model", emb.shape[0])[0] if split else 0
    ids = tokens.to_local().long() - lo
    mine = (ids >= 0) & (ids < rows.shape[0])
    x = F.embedding(torch.where(mine, ids, 0), rows) \
        * mine[..., None].to(rows.dtype)
    x = sh.from_partial(x, mesh, [sh.Partial() if i == tp and split else pl
                                  for i, pl in enumerate(tokens.placements)])
    return sh.constrain(mesh, x, (dp, None, None))


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous. The
    backward of an einsum can hand back a DTensor gradient with permuted
    strides, and DTensor then takes the backward of the head reshape as
    a view those strides do not allow (torch 2.13, whisper's attention);
    a contiguous gradient takes the copy."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _heads(x, n, hd):
    b, s, _ = x.shape
    x = x.reshape(b, s, n, hd).transpose(1, 2)          # (B,n,S,hd)
    return _DenseGrad.apply(x) if isinstance(x, sh.DTensor) else x


def _unheads(x):
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def project(x, w, n: int, hd: int, mesh=None):
    """``x`` (B, S, D) times ``w`` as ``n`` heads (B, n, S, hd). On a mesh
    the weight is gathered at use with its columns over TP, and the flat
    (B, S, n·hd) product is pinned (batch over DP, columns over TP)
    before the head reshape: GQA kv widths below the TP degree would
    otherwise leave its layout to propagation."""
    y = torch.matmul(x, use_weight(mesh, w, x.dtype, (None, "model")))
    if mesh is not None:
        y = sh.constrain(mesh, y, (sh.dp_axes_of(mesh), None, "model"))
    return _heads(y, n, hd)


def out_project(o, w, mesh=None):
    """Heads ``o`` (B, H, S, hd) back to (B, S, D) through ``w``, its rows
    over TP at use (the product sums over the model axis)."""
    return torch.matmul(_unheads(o), use_weight(mesh, w, o.dtype,
                                                ("model", None)))


def attention_sublayer(cfg: ModelConfig, p, x, *, causal: bool,
                       positions, mesh=None):
    """Returns (out, (k, v)) — k/v in (B, Hkv, S, hd) post-RoPE layout."""
    hd = cfg.head_dim_
    cd = x.dtype
    q = sh.head_constraint(mesh, project(x, p["wq"], cfg.n_heads, hd, mesh))
    k = sh.head_constraint(mesh, project(x, p["wk"], cfg.n_kv_heads, hd,
                                         mesh))
    v = sh.head_constraint(mesh, project(x, p["wv"], cfg.n_kv_heads, hd,
                                         mesh))
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
    return out_project(o, p["wo"], mesh), (k, v)


def _split_zxbcdt(cfg: ModelConfig, zxbcdt):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return torch.split(zxbcdt, [di, di, N, N, H], dim=-1)


_MIXER_PARAMS = ("conv_w", "dt_bias", "A_log", "ssm_norm")


def ssm_sublayer(cfg: ModelConfig, p, x, conv_state=None, ssm_state=None,
                 *, decode: bool = False, mesh=None):
    """Mamba2 mixer. x: (B, S, D) (S=1 when decoding). On a mesh it is
    TP-free, as the reference's: its projections are gathered whole at
    use, and everything between them (the convolution, the SSD scan or
    the decode recurrence, the gated norm) runs on each device's batch
    shard (``sharding.local_batch_map``), the sequence gathered where
    sequence parallelism split it."""
    cd = x.dtype
    zxbcdt = torch.matmul(x, use_weight(mesh, p["ssm_in"], cd))
    shared = [p[k] for k in _MIXER_PARAMS]
    if decode:
        y, new_conv, new_state = sh.local_batch_map(
            mesh, lambda *a: _mixer_decode(cfg, *a),
            (zxbcdt, conv_state, ssm_state), shared)
        return torch.matmul(y, use_weight(mesh, p["ssm_out"], cd)), \
            new_conv, new_state
    y = sh.local_batch_map(mesh, lambda *a: _mixer(cfg, *a), (zxbcdt,),
                           shared)
    return torch.matmul(y, use_weight(mesh, p["ssm_out"], cd)), None, None


def _mixer_decode(cfg: ModelConfig, zxbcdt, conv_state, ssm_state, conv_w,
                  dt_bias, A_log, ssm_norm):
    """One token of the mixer between its projections: (y, new conv
    state, new SSM state)."""
    cd = zxbcdt.dtype
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    new_conv = torch.cat([conv_state[:, 1:], xbc.float()], dim=1)
    xbc_tap = torch.cat([conv_state.to(cd), xbc], dim=1)
    y = torch.zeros_like(xbc)
    for i in range(cfg.conv_width):
        y = y + xbc_tap[:, i:i + 1] * conv_w[i].to(cd)
    xbc = F.silu(y)
    xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    dtv = F.softplus(dt[:, 0].float() + dt_bias.float())
    xh = xin[:, 0].reshape(-1, H, P)
    yh, new_state = ssm_lib.ssd_decode_step(
        ssm_state, xh, dtv, A_log, Bc[:, 0], Cc[:, 0])
    y = yh.reshape(xh.shape[0], 1, di).to(cd)
    y = L.rms_norm(y * F.silu(z), ssm_norm.to(cd), cfg.norm_eps)
    return y, new_conv, new_state


def _mixer(cfg: ModelConfig, zxbcdt, conv_w, dt_bias, A_log, ssm_norm):
    """The mixer between its projections over a full sequence."""
    cd = zxbcdt.dtype
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    xbc, _ = ssm_lib.causal_conv(xbc, conv_w.to(cd))
    xbc = F.silu(xbc)
    xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    dtv = F.softplus(dt.float() + dt_bias.float())
    b, s = zxbcdt.shape[:2]
    yh = ssm_lib.ssd_chunked(xin.reshape(b, s, H, P), dtv, A_log, Bc, Cc,
                             chunk=cfg.ssm_chunk)
    y = yh.reshape(b, s, di)
    return L.rms_norm(y * F.silu(z), ssm_norm.to(cd), cfg.norm_eps)


def ffn_sublayer(cfg: ModelConfig, p, x, mesh=None):
    if cfg.n_experts:
        b, s, d = x.shape
        y, _ = moe_lib.moe_ffn(
            x.reshape(b * s, d),
            {k: p[k] for k in ("router", "w1", "w2", "w3") if k in p},
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            activation=cfg.activation, mesh=mesh)
        return y.reshape(b, s, d)
    ax = {"w1": (None, "model"), "w3": (None, "model"),
          "w2": ("model", None)}
    return L.mlp(x, {k: use_weight(mesh, p[k], x.dtype, ax[k])
                     for k in ("w1", "w2", "w3") if k in p}, cfg.activation)


# -- full-sequence block ------------------------------------------------------

def make_block_fn(cfg: ModelConfig, *, causal: bool, mesh=None):
    """One block (layer) over a full sequence: ``block(x, p) -> (x,
    None)``, the layer loop's step."""
    def seq_shard(h):
        # the residual stream's layout is pinned at each block's ends:
        # left to propagation, the embedding's layout would travel
        # through the stack
        if mesh is None:
            return h
        dp = sh.dp_axes_of(mesh)
        return sh.constrain(mesh, h, (dp, "model", None) if cfg.seq_parallel
                            else (dp, None, None))

    def block(x, p):
        x = seq_shard(x)
        positions = torch.arange(x.shape[1], device=x.device)
        if cfg.family == "ssm":
            h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
            y, _, _ = ssm_sublayer(cfg, p, h, mesh=mesh)
            x = x + y
        elif cfg.hybrid_parallel:
            h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
            a, _ = attention_sublayer(cfg, p, h, causal=causal,
                                      positions=positions, mesh=mesh)
            s, _, _ = ssm_sublayer(cfg, p, h, mesh=mesh)
            x = x + 0.5 * (a + s)
            h = L.rms_norm(x, p["mlp_norm"].to(x.dtype), cfg.norm_eps)
            x = x + ffn_sublayer(cfg, p, h, mesh)
        else:
            h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
            a, _ = attention_sublayer(cfg, p, h, causal=causal,
                                      positions=positions, mesh=mesh)
            x = x + a
            h = L.rms_norm(x, p["mlp_norm"].to(x.dtype), cfg.norm_eps)
            x = x + ffn_sublayer(cfg, p, h, mesh)
        return seq_shard(x), None
    return block


def forward(cfg: ModelConfig, params, tokens, *, mesh=None,
            compute_dtype=torch.bfloat16, remat: bool = True,
            frames=None, scan_layers: bool = True):
    """Token ids (B, S) → logits (B, S, V). For enc-dec models ``frames``
    (B, enc_frames, D) are the stubbed modality-frontend embeddings."""
    with sh.plain_as_replicated(mesh):
        emb = embedding(params, compute_dtype, mesh)
        x = embed_tokens(emb, tokens, mesh)
        if cfg.enc_dec:
            return _whisper_forward(cfg, params, x, frames, compute_dtype,
                                    remat, mesh)
        x = _layer_loop(make_block_fn(cfg, causal=True, mesh=mesh), x,
                        params["blocks"], cfg.n_layers, remat)
        x = L.rms_norm(x, params["final_norm"].to(compute_dtype),
                       cfg.norm_eps)
        return lm_logits(cfg, params, x, compute_dtype, mesh, emb)


def lm_logits(cfg, params, x, compute_dtype, mesh=None, emb=None):
    """Final projection (tied embedding or ``lm_head``); the padded vocab
    rows are masked to -1e30. ``emb``: the table ``embedding`` gave, for
    a tied head. On a mesh the head is laid out (D whole, vocab over TP)
    and so are the logits (batch over DP, vocab over TP): left to
    propagation, the tied product could replicate the (B, S, V)
    logits."""
    if cfg.tie_embeddings:
        head = (embedding(params, compute_dtype, mesh) if emb is None
                else emb).T
    else:
        head = use_weight(mesh, params["lm_head"], compute_dtype,
                          (None, "model"))
    logits = torch.matmul(x, head)
    if mesh is not None:
        logits = sh.constrain(mesh, logits, (sh.dp_axes_of(mesh),)
                              + (None,) * (x.dim() - 2) + ("model",))
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=logits.device),
                             logits)
    return logits


# -- whisper (enc-dec) --------------------------------------------------------

def _pin(mesh, h):
    """The residual stream's layout, batch over DP (a mesh), for both of
    whisper's stacks."""
    if mesh is None:
        return h
    return sh.constrain(mesh, h, (sh.dp_axes_of(mesh), None, None))


def encode(cfg: ModelConfig, params, frames, compute_dtype,
           remat: bool = False, mesh=None):
    """The encoder stack over the stubbed frame embeddings."""
    enc = _pin(mesh, frames.to(compute_dtype)
               + params["enc_pos"].to(compute_dtype)[None])
    enc_block = make_block_fn(
        dataclasses.replace(cfg, family="dense", enc_dec=False,
                            n_kv_heads=cfg.n_heads), causal=False, mesh=mesh)
    enc = _layer_loop(enc_block, enc, params["enc_blocks"], cfg.enc_layers,
                      remat)
    return _pin(mesh, L.rms_norm(enc, params["enc_norm"].to(compute_dtype),
                                 cfg.norm_eps))


def _whisper_forward(cfg, params, x, frames, compute_dtype, remat, mesh):
    """Whisper's logits from the decoder's token embeddings ``x``."""
    enc = encode(cfg, params, frames, compute_dtype, remat, mesh)
    S = x.shape[1]
    x = _pin(mesh, x + params["dec_pos"].to(compute_dtype)[None, :S])
    dec_cfg = dataclasses.replace(cfg, enc_dec=False,
                                  n_kv_heads=cfg.n_heads)
    hd = cfg.head_dim_

    def dec_block(x, ps):
        p, pc = ps
        x = _pin(mesh, x)
        positions = torch.arange(x.shape[1], device=x.device)
        h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
        a, _ = attention_sublayer(dec_cfg, p, h, causal=True,
                                  positions=positions, mesh=mesh)
        x = x + a
        h = L.rms_norm(x, pc["norm"].to(x.dtype), cfg.norm_eps)
        n = cfg.n_heads
        o = L.blockwise_attention(project(h, pc["wq"], n, hd, mesh),
                                  project(enc, pc["wk"], n, hd, mesh),
                                  project(enc, pc["wv"], n, hd, mesh),
                                  causal=False)
        x = x + out_project(o, pc["wo"], mesh)
        h = L.rms_norm(x, p["mlp_norm"].to(x.dtype), cfg.norm_eps)
        x = x + ffn_sublayer(dec_cfg, p, h, mesh)
        return _pin(mesh, x), None
    x = _layer_loop(dec_block, x, (params["blocks"], params["cross"]),
                    cfg.n_layers, remat)
    x = L.rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    return lm_logits(cfg, params, x, compute_dtype, mesh)
