"""Parameters from the reference's layout: a tree of numpy arrays (the
reference's parameter tree after ``jax.tree.map(np.asarray, params)``)
into the same tree of torch tensors, keys and layouts unchanged.

The one conversion is bf16: numpy has no bf16 of its own, and the arrays
of a bf16 tree carry ``ml_dtypes``' bfloat16, which ``torch.from_numpy``
does not take; their bits are reinterpreted as torch.bfloat16 instead.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    # a C-ordered copy that keeps a 0-d array 0-d (``ascontiguousarray``
    # would make it 1-d)
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """A nested dict / list / tuple of numpy arrays (or scalars) → the
    same nesting of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)
