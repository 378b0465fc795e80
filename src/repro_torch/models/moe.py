"""Mixture-of-Experts FFN with sort-based token dispatch — the port of
``repro.models.moe``.

Top-k routing with bounded expert capacity: tokens are ranked within their
chosen expert (stable sort over expert ids), tokens past capacity are
dropped (GShard-style), features are scattered into a dense
(experts, capacity, d_model) buffer, experts run as batched einsums, and
outputs are combined back weighted by router probabilities. The reference
shards the expert axis over a device mesh; the port has none, so ``mesh``
must be None.

FLOPs scale with tokens·top_k (active experts), not n_experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _no_mesh


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, -(-cap // 8) * 8)


def topk_stable(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, the lower index first among equal values. A stable descending
    sort keeps that order on every device, which ``torch.topk`` does not
    promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x, router, *, k: int, capacity: int):
    """The dispatch plan of :func:`moe_ffn`: router probs (T, E), the
    normalised top-k weights (T, k), each (token, choice)'s expert
    ``flat_e``, its slot in that expert's buffer and whether it was kept
    (capacity)."""
    E = router.shape[1]
    logits = torch.matmul(x, router.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = topk_stable(probs, k)                     # (T, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    flat_e = top_i.reshape(-1)                              # (T*k,)
    Tk = flat_e.shape[0]
    # rank of each (token, slot) within its expert via stable sort
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # a scatter-add, not ``bincount``: the same counts, with no read of
    # the maximum back to the host and a kernel on ``meta``
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts               # exclusive
    rank_sorted = torch.arange(Tk, device=x.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < capacity
    slot = torch.where(keep, rank, 0)
    return probs, top_p, top_i, flat_e, slot, keep


def moe_ffn(x, params, *, top_k: int, capacity_factor: float,
            activation: str = "swiglu", mesh=None):
    """x: (T, D) token-major. params: router (D, E), w1/w3 (E, D, F),
    w2 (E, F, D). Returns ((T, D), router probs).

    Dispatch: capacity-bounded sort-based ranking, a scatter into a dense
    (E, C, D) buffer. A dropped (token, choice) lands on slot 0 with its
    features zeroed, so it adds nothing there, and its combine weight is
    zero."""
    _no_mesh(mesh)
    T, D = x.shape
    E = params["router"].shape[1]
    C = moe_capacity(T, E, top_k, capacity_factor)
    probs, top_p, _, flat_e, slot, keep = route(
        x, params["router"], k=top_k, capacity=C)

    tok_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)
    feats = x[tok_idx] * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, slot), feats, accumulate=True)

    w1 = params["w1"].to(x.dtype)
    w2 = params["w2"].to(x.dtype)
    if activation == "swiglu":
        g = torch.einsum("ecd,edf->ecf", buf, w1)
        u = torch.einsum("ecd,edf->ecf", buf, params["w3"].to(x.dtype))
        h = F.silu(g) * u
    else:
        h = torch.relu(torch.einsum("ecd,edf->ecf", buf, w1)) ** 2
    out_buf = torch.einsum("ecf,efd->ecd", h, w2)

    gathered = out_buf[flat_e, slot]                        # (T*k, D)
    weights = (top_p.reshape(-1) * keep).to(x.dtype)
    y = (gathered * weights[:, None]).reshape(T, top_k, D).sum(dim=1)
    return y, probs


def load_balance_loss(probs: torch.Tensor,
                      top_i: torch.Tensor | None = None) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · p̄_e."""
    E = probs.shape[-1]
    pbar = probs.mean(dim=0)
    if top_i is None:
        f = pbar
    else:
        idx = top_i.reshape(-1)
        f = torch.zeros((E,), device=probs.device).index_add_(
            0, idx, torch.full(idx.shape, 1.0 / idx.numel(),
                               device=probs.device))
    return E * torch.sum(f * pbar)
