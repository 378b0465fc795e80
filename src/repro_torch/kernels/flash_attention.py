"""Flash attention (causal, windowed or full; GQA) — the port of
``repro.kernels.flash_attention.flash_attention``.

q (BH, S, hd); k/v (BHkv, S, hd) with BH % BHkv == 0; query head h reads
KV head h // group. Scores and the softmax are float32 whatever the input
type; the output is in q's type. ``window`` > 0 limits each query to the
last ``window`` keys.

:func:`flash_attention_cuda` launches the hand-written kernels
(``csrc/flash_attention.cu``: one CTA per (head, 64-row query block), an
online softmax over 64-key tiles, head dim 64 or 128; float32 on the
CUDA cores, bf16 on the tensor cores through TMA and ``wgmma``, with P
split in two bf16 parts so that the output stays within half a bf16 ulp
of the float32 result). :func:`flash_attention_plain` is the same
function in plain torch: one block of query rows at a time against the
keys it can see, so no S×S score matrix of every head is ever held at
once.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ext

NAME = "flash_attention"
NEG_INF = -1e30
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version's score block: at most this many float32 scores
_PLAIN_SCORES = 1 << 28


def _check_shapes(q, k, v) -> tuple[int, int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q (BH, S, hd) and k, v (BHkv, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, hd = q.shape
    BHkv = k.shape[0]
    if k.shape[1:] != (S, hd) or BHkv < 1 or BH % BHkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    return BH, BHkv, S, hd


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int = DEFAULT_BLOCK_Q,
                          block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """The function of :func:`flash_attention_cuda` in plain torch.
    ``block_q`` and ``block_k`` are the reference's tile sizes and change
    nothing here."""
    del block_q, block_k
    BH, BHkv, S, hd = _check_shapes(q, k, v)
    group = BH // BHkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float().view(BHkv, group, S, hd)
    kf = k.float()[:, None]
    vf = v.float()[:, None]
    out = torch.empty((BHkv, group, S, hd), dtype=q.dtype, device=dev)
    rows = max(1, min(S, _PLAIN_SCORES // max(BH * S, 1)))
    for q0 in range(0, S, rows):
        q1 = min(S, q0 + rows)
        k0 = max(0, q0 - window + 1) if window else 0
        k1 = q1 if causal else S
        s = torch.matmul(qf[:, :, q0:q1], kf[:, :, k0:k1].transpose(-1, -2))
        s = s * scale
        qp = torch.arange(q0, q1, device=dev)[:, None]
        kp = torch.arange(k0, k1, device=dev)[None, :]
        mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask &= kp <= qp
        if window:
            mask &= kp > qp - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf[:, :, k0:k1]) / l.clamp_min(1e-20)
        out[:, :, q0:q1] = o.to(q.dtype)
    return out.view(BH, S, hd)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """The kernel. Takes contiguous CUDA tensors of one type, float32 or
    bf16, with head dim 64 or 128, and raises on anything else. The
    kernel tiles by 64 whatever ``block_q`` and ``block_k`` say (they are
    accepted for the reference's signature)."""
    del block_q, block_k
    BH, BHkv, S, hd = _check_shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"want q, k, v all float32 or all bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if BH > 65535 or S >= 2**31 // hd or window < 0:
        raise ValueError(f"BH {BH}, S {S}, window {window}: out of range")
    lib = ext.library(NAME)
    out = torch.empty_like(q)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
        BH // BHkv, S, hd, _DTYPES[q.dtype], int(bool(causal)), int(window),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    return out
