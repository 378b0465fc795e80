"""AdamW with gradient clipping and a cosine schedule — the port of
``repro.optim.adamw``.

The arithmetic is the reference's, in float32 per element: the
gradients are clipped by their global norm (summed leaf by leaf in the
reference's leaf order, ``repro_torch.tree``), the moments are
bias-corrected with ``b ** step`` in float32, and the decay is
``weight_decay · p``. ``state_dtype`` may be ``torch.bfloat16``: the
moments are then stored in bf16 and the update still computes in
float32.

Unlike the reference's functional update, this one writes the
parameters and moments **in place**, under ``torch.no_grad()``, and
drops each gradient once it has been applied. At granite-3-2b's full
width (2.53 G parameters) a functional update would hold the old and the
new parameters and moments of every leaf until its loop ended, 30 GB on
top of the 40.5 GB of float32 parameters, gradients and moments; in
place, the update adds one temporary of its largest leaf. Parameters
must therefore be leaf tensors, and a caller that wants the state from
before a step clones it first.

Over a device mesh the parameters are DTensors (``models/steps.py``):
``init`` gives each moment its parameter's placements and the step
counter is replicated (the reference's ``opt_state_shardings``), the
update runs on each device's shards in place, and the global gradient
norm is one reduction of the per-device partial sums of squares, each
replicated shard counted once (``global_norm``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.tree import leaves, tree_map


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``; takes the step as an int or a 0-d tensor and returns a
    float32 0-d tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # the moments' dtype: bf16 halves their residency; the update still
    # computes in float32
    state_dtype: torch.dtype = torch.float32

    def init(self, params):
        """Zero moments shaped and laid out as ``params`` (on their
        devices, ``meta`` included; a DTensor's with its placements) and a
        0-d int32 step counter, replicated over the parameters' mesh."""
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype)
        flat = leaves(params)
        device = flat[0].device if flat else None
        step = torch.zeros((), dtype=torch.int32, device=device)
        if flat and isinstance(flat[0], DTensor):
            mesh = flat[0].device_mesh
            step = DTensor.from_local(step, mesh,
                                      [Replicate()] * mesh.ndim)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}

    def update(self, grads, state, params):
        """``(params, state, grad_norm)``: the reference's update, with
        ``params`` and the moments written in place; ``grads`` is left
        as it was."""
        return self.update_flat(leaves(grads), state, params,
                                own_grads=False)

    @torch.no_grad()
    def update_flat(self, flat_g: list, state, params, *,
                    own_grads: bool = True):
        """``update`` on gradients given as a list in the reference's leaf
        order. Each entry is set to None once applied, so a caller that
        holds no other reference frees it there; with ``own_grads`` the
        float32 gradients' buffers also hold the update's temporaries."""
        flat_p = leaves(params)
        flat_m, flat_v = leaves(state["m"]), leaves(state["v"])
        if not len(flat_g) == len(flat_p) == len(flat_m) == len(flat_v):
            raise ValueError("gradients, parameters and moments differ in "
                             "structure")
        step = state["step"] + 1
        gnorm = global_norm(flat_g, flat_p)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        local_step = _local(step)
        lr = self.lr(local_step) if callable(self.lr) else self.lr
        stepf = local_step.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, stepf)
        bc2 = 1 - torch.pow(self.b2, stepf)
        for i, (p, m, v) in enumerate(zip(flat_p, flat_m, flat_v)):
            # each device updates its own shards: the moments and the
            # gradient share the parameter's placements
            g = _local(flat_g[i], p)
            flat_g[i] = None
            p, m, v = _local(p), _local(m), _local(v)
            # an owned float32 gradient's buffer takes the scaled gradient
            # and then the step (nothing reads the gradient after this)
            g = g.mul_(scale) if own_grads and g.dtype == torch.float32 \
                else g.float() * scale
            mf = m if m.dtype == torch.float32 else m.float()
            vf = v if v.dtype == torch.float32 else v.float()
            mf.mul_(self.b1).add_((1 - self.b1) * g)
            vf.mul_(self.b2).add_((1 - self.b2) * g * g)
            den = torch.div(vf, bc2).sqrt_().add_(self.eps)
            delta = torch.div(mf, bc1, out=g).div_(den)
            del den
            pf = p if p.dtype == torch.float32 else p.float()
            delta.add_(self.weight_decay * pf)
            pf.sub_(lr * delta)
            for dst, src in ((p, pf), (m, mf), (v, vf)):
                if dst is not src:
                    dst.copy_(src)
        return params, {"m": state["m"], "v": state["v"], "step": step}, \
            gnorm



def _local(x, like=None):
    """A DTensor's shard on this device (in ``like``'s placements first,
    where given), which in-place ops update; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    if like is not None and x.placements != like.placements:
        x = x.redistribute(like.device_mesh, like.placements)
    return x.to_local()


def global_norm(flat_g: list, flat_p: list) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient leaf, summed leaf by leaf in the
    reference's order. Over a mesh each device sums the squares of its
    own shards, a shard that a mesh axis replicates counted only on that
    axis's first device, and one global reduction of that one scalar
    adds the partial sums (DTensor issues it as an all-reduce a mesh
    dim)."""
    if not flat_g or not isinstance(flat_g[0], DTensor):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in flat_g))
    mesh = flat_p[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32,
                        device=flat_p[0].to_local().device)
    for g, p in zip(flat_g, flat_p):
        if any(c and not pl.is_shard() for c, pl in zip(coord, p.placements)):
            continue
        total = total + torch.sum(torch.square(_local(g, p).float()))
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.full_tensor())
