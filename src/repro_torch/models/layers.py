"""Core neural layers — the port of ``repro.models.layers``: RMSNorm,
RoPE, GQA attention (full / causal / sliding-window / decode) and the
MLP variants of the assigned archs.

Attention is blockwise (an online softmax over KV chunks), so no S×T
score matrix is held at once at 32k or 500k tokens; the hand-written
kernel ``repro_torch.kernels.ops.flash_attention`` computes the same
function on the card. Products run in float32 on the operands as given
(bf16 operands are exact in float32), as the reference asks with
``preferred_element_type=float32``.

Layouts: activations (B, S, D); attention heads (B, H, S, hd).
``decode_attention`` takes the model's ``mesh`` (a ``DeviceMesh``, or
None) and pins its layouts where the reference pins them;
``use_weight`` (the reference's ``model.use_weight``) lays a weight out
at use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as sh

NEG_INF = -1e30


def use_weight(mesh, w, cd, axes=None):
    """FSDP all-gather at use: ``w`` cast to the compute dtype first, so
    the gather moves ``cd`` bytes, then laid out as ``axes`` (the FSDP
    axis gathered, the TP axis kept; None: whole on every device).
    Without this the layout of a product would be left to propagation,
    which may replicate the activations over the data axis instead of
    gathering the much smaller weight shard. Without a mesh, the cast."""
    w = w.to(cd)
    if mesh is None:
        return w
    return sh.constrain(mesh, w, (None,) * w.dim() if axes is None else axes)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype) * w


def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, hd); positions: (S,) or broadcastable."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv         # (S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, Hkv, T, hd) → (B, Hkv·groups, T, hd): KV head j serves query
    heads j·groups … j·groups + groups - 1."""
    if groups == 1:
        return k
    B, Hkv, T, hd = k.shape
    return k[:, :, None].expand(B, Hkv, groups, T, hd).reshape(
        B, Hkv * groups, T, hd)


def _mm32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 accumulation and a float32 result."""
    return torch.einsum(eq, a.float(), b.float())


def blockwise_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                        chunk: int = 1024, window: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, H, S, hd); k/v: (B, Hkv, T, hd). ``q_offset``: absolute position
    of q[0]. ``window`` > 0 bounds lookback (sliding-window semantics).
    """
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // Hkv)
    v = repeat_kv(v, H // Hkv)
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, T)
    n_chunks = -(-T // chunk)
    pad_t = n_chunks * chunk - T
    if pad_t:
        k = F.pad(k, (0, 0, 0, pad_t))
        v = F.pad(v, (0, 0, 0, pad_t))
    dev = q.device
    q_pos = q_offset + torch.arange(S, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        s = _mm32("bhsd,bhtd->bhst", q, kb) * scale
        t_pos = ci * chunk + torch.arange(chunk, device=dev)
        mask = t_pos[None, :] <= q_pos[:, None] if causal else \
            torch.ones((S, chunk), dtype=torch.bool, device=dev)
        if window:
            mask = mask & (t_pos[None, :] > q_pos[:, None] - window)
        mask = mask & (t_pos < T)[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mm32("bhst,bhtd->bhsd",
                                            p.to(vb.dtype), vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-20)
    return out.to(q.dtype)


def sliding_window_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Banded causal attention: O(S·2W) via per-block two-chunk lookback.

    Exact for self-attention where q and kv cover the same positions.
    q: (B, H, S, hd); k/v: (B, Hkv, S, hd). Requires S % window == 0 or
    S < window (falls back to windowed blockwise).
    """
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    W = window
    if S <= W or S % W != 0:
        return blockwise_attention(q, k, v, causal=True, chunk=min(S, W),
                                   window=W)
    k = repeat_kv(k, H // Hkv)
    v = repeat_kv(v, H // Hkv)
    nb = S // W
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qb = q.reshape(B, H, nb, W, hd)
    kb = k.reshape(B, H, nb, W, hd)
    vb = v.reshape(B, H, nb, W, hd)
    k_prev = torch.cat([torch.zeros_like(kb[:, :, :1]), kb[:, :, :-1]],
                       dim=2)
    v_prev = torch.cat([torch.zeros_like(vb[:, :, :1]), vb[:, :, :-1]],
                       dim=2)
    k2 = torch.cat([k_prev, kb], dim=3)                 # (B,H,nb,2W,hd)
    v2 = torch.cat([v_prev, vb], dim=3)
    s = _mm32("bhnsd,bhntd->bhnst", qb, k2) * scale
    qpos = torch.arange(W, device=dev)[:, None]
    tpos = torch.arange(2 * W, device=dev)[None, :] - W
    mask = (tpos <= qpos) & (tpos > qpos - W)
    first = torch.arange(nb, device=dev) == 0
    tvalid = (tpos >= 0) | (~first[:, None, None])
    s = torch.where(mask[None, None, None] & tvalid[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _mm32("bhnst,bhntd->bhnsd", p.to(v2.dtype), v2)
    return out.reshape(B, H, S, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, mesh=None) -> torch.Tensor:
    """Single-token decode: q (B, H, 1, hd) against cache (B, Hkv, S, hd),
    masked to positions ≤ pos.

    On a mesh the cache is sequence-sharded over the model axis and the
    scores are kept so; the query heads are replicated (resharding the
    cache from S to H would move it whole every step), and the output is
    batch over DP."""
    B, H, _, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    dp = None if mesh is None else sh.dp_axes_of(mesh)
    q = sh.constrain(mesh, q, (dp, None, None, None))
    k_cache = repeat_kv(k_cache, H // Hkv)
    v_cache = repeat_kv(v_cache, H // Hkv)
    s = sh.constrain(mesh, _mm32("bhd,bhtd->bht", q[:, :, 0], k_cache),
                     (dp, None, "model"))
    s = s / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = sh.constrain(mesh, _mm32("bht,bhtd->bhd", p.to(v_cache.dtype),
                                   v_cache), (dp, None, None))
    return out[:, :, None].to(q.dtype)


# -- MLPs ---------------------------------------------------------------------

def mlp(x, params, activation: str):
    if activation == "swiglu":
        g = torch.matmul(x, params["w1"])
        u = torch.matmul(x, params["w3"])
        h = F.silu(g) * u
    elif activation == "squared_relu":
        h = torch.relu(torch.matmul(x, params["w1"]))
        h = h * h
    elif activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.matmul(x, params["w1"]), approximate="tanh")
    else:
        raise ValueError(activation)
    return torch.matmul(h, params["w2"])
