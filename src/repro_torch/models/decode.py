"""Serving path: cache construction, prefill, and single-token decode —
the port of ``repro.models.decode``.

Cache layouts (leading axis = layers):

  * attention archs: k/v (L, B, Hkv, C, hd); C = seq_len for full
    attention, C = sliding window for SWA archs (ring buffer, slot =
    pos % W — keys are RoPE-rotated at write time so ring order is
    irrelevant to softmax attention).
  * SSM/hybrid archs: ssm_state (L, B, H, N, P) + conv_state
    (L, B, K-1, conv_dim), float32 — constant-size state.
  * enc-dec (whisper): self-attention cache + cross-attention K/V
    computed once from the encoder output.

The K/V cache is ``compute_dtype``; ``pos`` is a 0-d int32 tensor on the
model's device. Every entry point returns a new cache and leaves the one
it was given as it was, as the reference's does.

On a device mesh (``mesh``, a ``DeviceMesh``) the embeddings are pinned
batch over DP, and every sublayer takes the mesh and pins its weights
and projections as the full-sequence forward does (the reference passes
its mesh to the FFN and decode attention only and leaves the rest to
GSPMD). ``prefill`` and ``decode_step`` return the cache laid out by
``parallel/sharding.cache_shardings``, as the reference's jitted steps'
``out_shardings`` lay it.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (_split_zxbcdt, attention_sublayer,
                                      embed_tokens, embedding, encode,
                                      ffn_sublayer, lm_logits, out_project,
                                      project, ssm_sublayer, tree_index,
                                      use_weight)
from repro_torch.parallel import sharding as sh


def _loop(layer, x, xs, n_layers: int):
    """The reference's ``lax.scan`` over per-layer (params, cache) slices:
    a Python loop that stacks each layer's outputs along a new axis 0."""
    outs_acc = []
    for i in range(n_layers):
        x, outs = layer(x, tree_index(xs, i))
        outs_acc.append(outs)
    stacked = {k: torch.stack([o[k] for o in outs_acc])
               for k in outs_acc[0]} if outs_acc else {}
    return x, stacked


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    nl, hd = cfg.n_layers, cfg.head_dim_
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32,
                                      device=device)}
    C = cache_len(cfg, seq_len)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    if cfg.family != "ssm":
        cache["k"] = zeros((nl, batch, cfg.n_kv_heads, C, hd), dtype)
        cache["v"] = zeros((nl, batch, cfg.n_kv_heads, C, hd), dtype)
    if cfg.family in ("ssm", "hybrid"):
        H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        conv_dim = cfg.d_inner + 2 * N
        cache["ssm_state"] = zeros((nl, batch, H, N, P), torch.float32)
        cache["conv_state"] = zeros(
            (nl, batch, cfg.conv_width - 1, conv_dim), torch.float32)
    if cfg.enc_dec:
        cache["cross_k"] = zeros(
            (nl, batch, cfg.n_heads, cfg.enc_frames, hd), dtype)
        cache["cross_v"] = zeros(
            (nl, batch, cfg.n_heads, cfg.enc_frames, hd), dtype)
    return cache


# -- decode -------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params, cache: dict, tokens,
                *, mesh=None, compute_dtype=torch.bfloat16,
                scan_layers: bool = True):
    """tokens (B,) → (logits (B, V), new cache)."""
    with sh.plain_as_replicated(mesh):
        logits, cache = _decode_step(cfg, params, cache, tokens, mesh,
                                     compute_dtype)
    return logits, _lay_out_cache(mesh, cache)


def _decode_step(cfg, params, cache, tokens, mesh, compute_dtype):
    pos = cache["pos"]
    emb = embedding(params, compute_dtype, mesh)
    x = embed_tokens(emb, tokens[:, None], mesh)
    if cfg.enc_dec:
        # ``index_select`` of a one-element index: indexing with the 0-d
        # ``pos`` would read it back to the host (``.item()``)
        x = x + params["dec_pos"].to(compute_dtype).index_select(
            0, pos.long().reshape(1))[None]
    positions = pos[None]
    C = cache["k"].shape[3] if "k" in cache else 0
    slot = pos % C if (cfg.sliding_window and C) else pos
    hd = cfg.head_dim_

    def attn_decode(p, h, k_l, v_l):
        cd = h.dtype
        q = project(h, p["wq"], cfg.n_heads, hd, mesh)
        k = project(h, p["wk"], cfg.n_kv_heads, hd, mesh)
        v = project(h, p["wv"], cfg.n_kv_heads, hd, mesh)
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"].to(cd), cfg.norm_eps)
            k = L.rms_norm(k, p["k_norm"].to(cd), cfg.norm_eps)
        if cfg.rope_fraction > 0:
            q = L.apply_rope(q, positions, fraction=cfg.rope_fraction,
                             theta=cfg.rope_theta)
            k = L.apply_rope(k, positions, fraction=cfg.rope_fraction,
                             theta=cfg.rope_theta)
        # the new key and value at ``slot``, into a new layer cache (the
        # reference's select against an iota; no host read of ``slot``)
        write = (torch.arange(C, device=h.device) == slot)[None, None, :,
                                                              None]
        k_l = torch.where(write, k.to(k_l.dtype), k_l)
        v_l = torch.where(write, v.to(v_l.dtype), v_l)
        o = L.decode_attention(q, k_l, v_l,
                               torch.clamp(pos, max=C - 1)
                               if cfg.sliding_window else pos, mesh)
        return out_project(o, p["wo"], mesh), k_l, v_l

    def layer(h_in, xs):
        p = xs["p"]
        outs = {}
        hn = L.rms_norm(h_in, p["attn_norm"].to(h_in.dtype), cfg.norm_eps)
        if cfg.family == "ssm":
            y, conv, state = ssm_sublayer(
                cfg, p, hn, xs["conv_state"], xs["ssm_state"], decode=True,
                mesh=mesh)
            h = h_in + y
            outs.update(conv_state=conv, ssm_state=state)
        elif cfg.hybrid_parallel:
            a, k_l, v_l = attn_decode(p, hn, xs["k"], xs["v"])
            s, conv, state = ssm_sublayer(
                cfg, p, hn, xs["conv_state"], xs["ssm_state"], decode=True,
                mesh=mesh)
            h = h_in + 0.5 * (a + s)
            outs.update(k=k_l, v=v_l, conv_state=conv, ssm_state=state)
            hn2 = L.rms_norm(h, p["mlp_norm"].to(h.dtype), cfg.norm_eps)
            h = h + ffn_sublayer(cfg, p, hn2)
        else:
            a, k_l, v_l = attn_decode(p, hn, xs["k"], xs["v"])
            h = h_in + a
            outs.update(k=k_l, v=v_l)
            if cfg.enc_dec:
                pc = xs["pc"]
                hn2 = L.rms_norm(h, pc["norm"].to(h.dtype), cfg.norm_eps)
                q = project(hn2, pc["wq"], cfg.n_heads, hd, mesh)
                o = L.decode_attention(q, xs["cross_k"], xs["cross_v"],
                                       cfg.enc_frames, mesh)
                h = h + out_project(o, pc["wo"], mesh)
                outs.update(cross_k=xs["cross_k"], cross_v=xs["cross_v"])
            hn2 = L.rms_norm(h, p["mlp_norm"].to(h.dtype), cfg.norm_eps)
            h = h + ffn_sublayer(cfg, p, hn2, mesh)
        return h, outs

    xs: dict = {"p": params["blocks"]}
    for key in ("k", "v", "ssm_state", "conv_state", "cross_k", "cross_v"):
        if key in cache:
            xs[key] = cache[key]
    if cfg.enc_dec:
        xs["pc"] = params["cross"]
    x, outs = _loop(layer, x, xs, cfg.n_layers)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    new_cache.update(outs)
    x = L.rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    return lm_logits(cfg, params, x[:, 0], compute_dtype, mesh, emb), \
        new_cache


# -- prefill ------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, tokens, *, mesh=None,
            compute_dtype=torch.bfloat16, frames=None, remat: bool = True,
            max_len: int | None = None, scan_layers: bool = True):
    """Full-sequence forward building the cache; returns (last-token
    logits (B, V), cache). ``max_len`` reserves cache slots beyond S for
    subsequent decode steps."""
    with sh.plain_as_replicated(mesh):
        logits, cache = _prefill(cfg, params, tokens, mesh, compute_dtype,
                                 frames, max_len)
    return logits, _lay_out_cache(mesh, cache)


def _lay_out_cache(mesh, cache: dict) -> dict:
    if mesh is None:
        return cache
    plan = sh.make_plan(mesh)
    return sh.shard_tree(plan, cache, sh.cache_shardings(plan, cache))


def _prefill(cfg, params, tokens, mesh, compute_dtype, frames, max_len):
    B, S = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, B, max_len or S, compute_dtype, dev)
    emb = embedding(params, compute_dtype, mesh)
    x = embed_tokens(emb, tokens, mesh)
    enc = None
    if cfg.enc_dec:
        # encoder + cross K/V
        enc = encode(cfg, params, frames, compute_dtype, mesh=mesh)
        x = x + params["dec_pos"].to(compute_dtype)[None, :S]

    hd = cfg.head_dim_
    W = cache_len(cfg, max_len or S)
    positions = torch.arange(S, device=dev)

    def layer(h_in, xs):
        p = xs["p"]
        outs = {}
        hn = L.rms_norm(h_in, p["attn_norm"].to(h_in.dtype), cfg.norm_eps)
        if cfg.family == "ssm":
            y, _, _ = ssm_sublayer(cfg, p, hn, mesh=mesh)
            h = h_in + y
            outs["ssm_state"], outs["conv_state"] = _ssm_final_state(
                cfg, p, hn, mesh)
        elif cfg.hybrid_parallel:
            a, (k, v) = attention_sublayer(cfg, p, hn, causal=True,
                                           positions=positions, mesh=mesh)
            s, _, _ = ssm_sublayer(cfg, p, hn, mesh=mesh)
            h = h_in + 0.5 * (a + s)
            outs["ssm_state"], outs["conv_state"] = _ssm_final_state(
                cfg, p, hn, mesh)
            outs["k"], outs["v"] = _ring(k, W), _ring(v, W)
            hn2 = L.rms_norm(h, p["mlp_norm"].to(h.dtype), cfg.norm_eps)
            h = h + ffn_sublayer(cfg, p, hn2, mesh)
        else:
            a, (k, v) = attention_sublayer(cfg, p, hn, causal=True,
                                           positions=positions, mesh=mesh)
            h = h_in + a
            outs["k"], outs["v"] = _ring(k, W), _ring(v, W)
            if cfg.enc_dec:
                pc = xs["pc"]
                hn2 = L.rms_norm(h, pc["norm"].to(h.dtype), cfg.norm_eps)
                n = cfg.n_heads
                q = project(hn2, pc["wq"], n, hd, mesh)
                ck = project(enc, pc["wk"], n, hd, mesh)
                cv = project(enc, pc["wv"], n, hd, mesh)
                o = L.blockwise_attention(q, ck, cv, causal=False)
                h = h + out_project(o, pc["wo"], mesh)
                outs["cross_k"], outs["cross_v"] = ck, cv
            hn2 = L.rms_norm(h, p["mlp_norm"].to(h.dtype), cfg.norm_eps)
            h = h + ffn_sublayer(cfg, p, hn2, mesh)
        return h, outs

    xs: dict = {"p": params["blocks"]}
    if cfg.enc_dec:
        xs["pc"] = params["cross"]
    x, outs = _loop(layer, x, xs, cfg.n_layers)
    cache.update(outs)
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=dev)
    x = L.rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    return lm_logits(cfg, params, x[:, -1], compute_dtype, mesh, emb), cache


def _ring(k, W):
    """Store the last W positions at ring slots (pos % W)."""
    S = k.shape[2]
    if W == S:
        return k
    if W > S:
        # a concatenation, not ``F.pad``: torch 2.11's DTensor gives a
        # padded tensor one placement on a two-dim mesh
        B, H, _, hd = k.shape
        return torch.cat([k, torch.zeros((B, H, W - S, hd), dtype=k.dtype,
                                         device=k.device)], dim=2)
    tail = k[:, :, S - W:]                       # positions S-W..S-1
    if S % W == 0:
        # position S-W+j lands on slot (S-W+j) % W = j: the tail is
        # already in ring order
        return tail
    slots = torch.arange(S - W, S, device=k.device) % W
    out = torch.zeros_like(tail)
    out[:, :, slots] = tail
    return out


def _ssm_final_state(cfg: ModelConfig, p, hn, mesh=None):
    """Exact final (ssm_state, conv_state) after a full-sequence prefill;
    on a mesh, computed on each device's batch shard."""
    zxbcdt = torch.matmul(hn, use_weight(mesh, p["ssm_in"], hn.dtype))
    return sh.local_batch_map(
        mesh, lambda *a: _final_state(cfg, *a), (zxbcdt,),
        (p["conv_w"], p["dt_bias"], p["A_log"]))


def _final_state(cfg: ModelConfig, zxbcdt, conv_w, dt_bias, A_log):
    cd = zxbcdt.dtype
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    di, N = cfg.d_inner, cfg.ssm_state
    _, xin0, Bc0, Cc0, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc = torch.cat([xin0, Bc0, Cc0], dim=-1)
    conv_state = xbc[:, -(cfg.conv_width - 1):].float()
    xbc_c, _ = ssm_lib.causal_conv(xbc, conv_w.to(cd))
    xbc_c = torch.nn.functional.silu(xbc_c)
    xin, Bc, Cc = torch.split(xbc_c, [di, N, N], dim=-1)
    dtv = torch.nn.functional.softplus(dt.float() + dt_bias.float())
    b, s = zxbcdt.shape[:2]
    a = -torch.exp(A_log.float())
    da = dtv * a                                  # (b,s,H)
    # final state = Σ_t exp(Σ_{u>t} da_u) dt_t B_t ⊗ x_t
    rev_cum = torch.flip(torch.cumsum(torch.flip(da, [1]), dim=1), [1]) - da
    w = torch.exp(rev_cum) * dtv                  # (b,s,H)
    xh = xin.reshape(b, s, H, P).float()
    state = torch.einsum("bsn,bshp,bsh->bhnp", Bc.float(), xh, w)
    return state, conv_state
