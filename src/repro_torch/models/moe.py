"""Mixture-of-Experts FFN with sort-based token dispatch — the port of
``repro.models.moe``.

Top-k routing with bounded expert capacity: tokens are ranked within their
chosen expert (stable sort over expert ids), tokens past capacity are
dropped (GShard-style), features are scattered into a dense
(experts, capacity, d_model) buffer, experts run as batched einsums, and
outputs are combined back weighted by router probabilities.

On a device mesh (``mesh``, a ``DeviceMesh``) the expert axis of the
buffer and of the expert weights is sharded over the ``model`` axis
(expert parallelism), as the reference's constraints lay it. The
dispatch plan (each choice's rank within its expert) is a sort over all
the tokens, so every device computes it whole from the gathered choices;
the tokens are gathered over the data axis, each device fills the rows
of its own experts, and the combine sums each device's experts' outputs
(a reduction over ``model``) before the tokens go back to their batch
shards. The reference leaves the token exchange to GSPMD.

FLOPs scale with tokens·top_k (active experts), not n_experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.layers import use_weight
from repro_torch.parallel import sharding as sh


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
    probs, top_p, top_i = _router(x, router, k)
    flat_e = top_i.reshape(-1)                              # (T*k,)
    slot, keep = _slots(flat_e, router.shape[1], capacity)
    return probs, top_p, top_i, flat_e, slot, keep


def _router(x, router, k: int):
    """Router probs (T, E) and the normalised top-k weights and experts
    (T, k)."""
    logits = torch.matmul(x, router.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = topk_stable(probs, k)                     # (T, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def _slots(flat_e, E: int, capacity: int):
    """Each (token, choice)'s slot in its expert's buffer and whether it
    was kept: its rank among the choices of that expert (a stable sort),
    below ``capacity``."""
    Tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # a scatter-add, not ``bincount``: the same counts, with no read of
    # the maximum back to the host and a kernel on ``meta``
    counts = torch.zeros(E, dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts               # exclusive
    rank_sorted = torch.arange(Tk, device=flat_e.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < capacity
    return torch.where(keep, rank, 0), keep


def moe_ffn(x, params, *, top_k: int, capacity_factor: float,
            activation: str = "swiglu", mesh=None):
    """x: (T, D) token-major. params: router (D, E), w1/w3 (E, D, F),
    w2 (E, F, D). Returns ((T, D), router probs).

    Dispatch: capacity-bounded sort-based ranking, a scatter into a dense
    (E, C, D) buffer. A dropped (token, choice) lands on slot 0 with its
    features zeroed, so it adds nothing there, and its combine weight is
    zero."""
    if mesh is not None:
        return _moe_ffn_mesh(x, params, top_k=top_k,
                             capacity_factor=capacity_factor,
                             activation=activation, mesh=mesh)
    T, D = x.shape
    E = params["router"].shape[1]
    C = moe_capacity(T, E, top_k, capacity_factor)
    probs, top_p, _, flat_e, slot, keep = route(
        x, params["router"], k=top_k, capacity=C)

    tok_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)
    feats = x[tok_idx] * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, slot), feats, accumulate=True)

    out_buf = _experts(buf, {k: params[k].to(x.dtype)
                             for k in ("w1", "w2", "w3") if k in params},
                       activation)
    gathered = out_buf[flat_e, slot]                        # (T*k, D)
    weights = (top_p.reshape(-1) * keep).to(x.dtype)
    y = (gathered * weights[:, None]).reshape(T, top_k, D).sum(dim=1)
    return y, probs


def _experts(buf, w, activation: str):
    """The experts as batched einsums over the (E, C, D) buffer."""
    if activation == "swiglu":
        g = torch.einsum("ecd,edf->ecf", buf, w["w1"])
        u = torch.einsum("ecd,edf->ecf", buf, w["w3"])
        h = F.silu(g) * u
    else:
        h = torch.relu(torch.einsum("ecd,edf->ecf", buf, w["w1"])) ** 2
    return torch.einsum("ecf,efd->ecd", h, w["w2"])


def _moe_ffn_mesh(x, params, *, top_k: int, capacity_factor: float,
                  activation: str, mesh):
    """``moe_ffn`` over a ``DeviceMesh``: ``x`` (T, D) a DTensor, tokens
    over DP. The same slots, buffer rows and sums as without a mesh."""
    sh.require_device_mesh(mesh)
    T, D = x.shape
    E = params["router"].shape[1]
    C = moe_capacity(T, E, top_k, capacity_factor)
    probs, top_p, top_i = _router(x, params["router"], top_k)
    # the plan, whole on every device: the choices are (T, k) integers
    flat_e = top_i.full_tensor().reshape(-1)
    slot, keep = _slots(flat_e, E, C)
    # this device's experts: its chunk of E over the model axis (E whole
    # where the guard drops the axis)
    plan = sh.make_plan(mesh)
    experts = sh._spec(plan, (E, C, D), ("model", None, None), strict=False)
    tp = mesh.mesh_dim_names.index("model")
    lo, hi = sh.local_range(mesh, "model", E) if experts[0] else (0, E)
    n_local = hi - lo
    mine = (flat_e >= lo) & (flat_e < hi)
    local_e = torch.clamp(flat_e - lo, 0, max(n_local - 1, 0))

    # each device's gradient of the whole tokens and weights is its own
    # experts' share: partial over the model axis
    shares = [Partial() if i == tp and experts[0] else Replicate()
              for i in range(mesh.ndim)]
    xs = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=shares)                             # (T, D)
    tok_idx = torch.arange(T, device=xs.device).repeat_interleave(top_k)
    feats = xs[tok_idx] * (keep & mine)[:, None].to(xs.dtype)
    buf = torch.zeros((n_local, C, D), dtype=xs.dtype, device=xs.device)
    buf.index_put_((local_e, slot), feats, accumulate=True)
    buf = DTensor.from_local(buf, mesh, sh.placements(plan, experts),
                             run_check=False, shape=(E, C, D),
                             stride=(C * D, D, 1))
    w = {k: use_weight(mesh, params[k], x.dtype, experts)
         for k in ("w1", "w2", "w3") if k in params}
    out_buf = sh.constrain(mesh, _experts(buf, w, activation), experts)

    weights = (top_p.full_tensor(grad_placements=shares).reshape(-1)
               * (keep & mine)).to(xs.dtype)
    gathered = out_buf.to_local()[local_e, slot]            # (T*k, D)
    y = (gathered * weights[:, None]).reshape(T, top_k, D).sum(dim=1)
    # each device holds its experts' share of every token: a sum over
    # the model axis, then the tokens back to their DP shards
    y = sh.from_partial(y, mesh, shares)
    return sh.constrain(mesh, y, (sh.dp_axes_of(mesh), None)), probs


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
