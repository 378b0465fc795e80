"""Training and serving step builders shared by the entry points — the
port of ``repro.models.steps``: the loss, the train step (gradients by
``torch.autograd``, optional gradient accumulation, the AdamW update in
place), the prefill step and the serve step.

With ``mesh`` (a ``DeviceMesh``) each step runs over the mesh, as the
reference's steps jitted with ``in_shardings`` / ``out_shardings`` do:
its parameter, optimizer-state, batch and cache arguments are DTensors
laid out by the rule tables (``parallel/sharding.shard_tree`` with
``param_shardings`` and the rest), the gradients come back with their
parameters' placements, and the prefill and serve steps return the cache
laid out by ``cache_shardings`` (``models/decode.py``). The loss,
``grad_norm`` and logits come back whole on every device, plain
tensors.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves

if TYPE_CHECKING:       # the serving path loads no optimizer
    from repro_torch.optim.adamw import AdamW


def softmax_xent(logits, labels):
    """Cross entropy in float32 over a (possibly vocab-sharded) logits
    tensor. The gold logit is a masked sum over a compare against the
    vocab index, as the reference takes it: under a vocab-sharded layout
    a gather would move the full vocab, the compare and sum reduce
    (B, S) partial sums."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    eq = torch.arange(V, device=logits.device) == labels[..., None]
    gold = torch.sum(torch.where(eq, logits, 0.0), dim=-1)
    return torch.mean(lse - gold)


def make_loss_fn(cfg: ModelConfig, *, mesh=None, remat=True,
                 compute_dtype=torch.bfloat16, scan_layers=True):
    def loss_fn(params, batch):
        logits = model_lib.forward(
            cfg, params, batch["tokens"], mesh=mesh, remat=remat,
            compute_dtype=compute_dtype, frames=batch.get("frames"),
            scan_layers=scan_layers)
        if mesh is not None:
            logits = sh.constrain(mesh, logits,
                                  (sh.dp_axes_of(mesh), None, "model"))
        return softmax_xent(logits, batch["labels"])
    return loss_fn


def make_grad_fn(cfg: ModelConfig, *, mesh=None, remat=True,
                 compute_dtype=torch.bfloat16, scan_layers=True,
                 accum_steps: int = 1):
    """``grad_fn(params, batch) -> (loss, grads)``: the loss, detached,
    and its gradient with respect to every parameter leaf, a list in the
    reference's leaf order (``repro_torch.tree``).

    The parameters are marked as requiring grad for the call and
    unmarked after it, so they stay leaf tensors that need no grad
    outside it. ``accum_steps`` > 1 splits the batch along axis 0 into
    that many microbatches, as the reference's reshape does, sums their
    float32 gradients in microbatch order into one extra float32 buffer
    a leaf, and divides the summed loss and gradients by
    ``accum_steps``.

    On a mesh the loss comes back whole on every device and each
    gradient is a DTensor with its parameter's placements (the backward
    of each weight's gather at use reduce-scatters its gradient); each
    microbatch is laid out as ``batch_shardings`` lays a batch."""
    loss_fn = make_loss_fn(cfg, mesh=mesh, remat=remat,
                           compute_dtype=compute_dtype,
                           scan_layers=scan_layers)

    def value_and_grad(params, flat_p, batch):
        # the backward pass too meets plain masks saved by the forward
        with sh.plain_as_replicated(mesh):
            loss = loss_fn(params, batch)
            if mesh is not None:
                loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, flat_p, allow_unused=True)
        # a leaf the loss does not read (an SSM block's ``mlp_norm``) has
        # a zero gradient, as JAX gives it
        return loss.detach(), [torch.zeros_like(p) if g is None
                               else sh.like(g, p)
                               for p, g in zip(flat_p, grads)]

    def microbatch(batch, i):
        if mesh is None:
            return {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                 + tuple(v.shape[1:]))[i]
                    for k, v in batch.items()}
        # the token ids, gathered (a few KB), cut, and laid out again
        whole = sh.gather_tree(batch)
        n = next(iter(whole.values())).shape[0] // accum_steps
        part = {k: v[i * n:(i + 1) * n] for k, v in whole.items()}
        plan = sh.make_plan(mesh)
        return sh.shard_tree(plan, part, sh.batch_shardings(plan, part))

    def grad_fn(params, batch):
        flat_p = leaves(params)
        for p in flat_p:
            p.requires_grad_(True)
        try:
            if accum_steps == 1:
                return value_and_grad(params, flat_p, batch)
            loss = torch.zeros((), dtype=torch.float32,
                               device=flat_p[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in flat_p]
            for i in range(accum_steps):
                l, g = value_and_grad(params, flat_p,
                                      microbatch(batch, i))
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                del g
            for g in grads:
                g.div_(accum_steps)
            return loss / accum_steps, grads
        finally:
            for p in flat_p:
                p.requires_grad_(False)
    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, mesh=None,
                    remat=True, compute_dtype=torch.bfloat16,
                    scan_layers=True, accum_steps: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``make_grad_fn``'s loss and gradients,
    then ``optimizer``'s update, which writes the parameters and moments
    in place and frees each gradient as it applies it
    (``optim/adamw.py``)."""
    grad_fn = make_grad_fn(cfg, mesh=mesh, remat=remat,
                           compute_dtype=compute_dtype,
                           scan_layers=scan_layers, accum_steps=accum_steps)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, gnorm = optimizer.update_flat(grads, opt_state,
                                                         params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ModelConfig, *, mesh=None,
                      compute_dtype=torch.bfloat16, scan_layers=True):
    def prefill_step(params, batch):
        logits, cache = decode_lib.prefill(
            cfg, params, batch["tokens"], mesh=mesh,
            compute_dtype=compute_dtype, frames=batch.get("frames"),
            scan_layers=scan_layers)
        return sh.gather_tree(logits), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None,
                    compute_dtype=torch.bfloat16, scan_layers=True):
    def serve_step(params, cache, tokens):
        logits, cache = decode_lib.decode_step(
            cfg, params, cache, tokens, mesh=mesh,
            compute_dtype=compute_dtype, scan_layers=scan_layers)
        logits = sh.gather_tree(logits)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache
    return serve_step
