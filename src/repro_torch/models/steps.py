"""Serving step builders shared by the entry points — the port of
``repro.models.steps``: the loss (forward only), the prefill step and the
serve step. The train step, and the optimiser it needs, are not ported
yet, so this module imports no optimiser.
"""

from __future__ import annotations

import torch

from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def softmax_xent(logits, labels):
    """Cross entropy in float32. The gold logit is a masked sum over a
    compare against the vocab index, as the reference takes it."""
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
        return softmax_xent(logits, batch["labels"])
    return loss_fn


def make_prefill_step(cfg: ModelConfig, *, mesh=None,
                      compute_dtype=torch.bfloat16, scan_layers=True):
    def prefill_step(params, batch):
        return decode_lib.prefill(cfg, params, batch["tokens"], mesh=mesh,
                                  compute_dtype=compute_dtype,
                                  frames=batch.get("frames"),
                                  scan_layers=scan_layers)
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None,
                    compute_dtype=torch.bfloat16, scan_layers=True):
    def serve_step(params, cache, tokens):
        logits, cache = decode_lib.decode_step(
            cfg, params, cache, tokens, mesh=mesh,
            compute_dtype=compute_dtype, scan_layers=scan_layers)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache
    return serve_step
