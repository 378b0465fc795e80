"""Sorting and segmented scan — the plain torch twins of ``csrc/sortnet.cuh``.

The port of ``repro.kernels.sortnet``. The reference sorts a resident
batch with a select-only bitonic network whose last key is the original
position, so its order is total and stable, and it scans segments with
log-step shifts. The CUDA header keeps that order (encoded key lanes
plus the position) but runs the network in global memory; these plain
versions compute the same functions for CPU tensors and as the
yardstick on the card:

* :func:`lexsort_order` — the permutation the network applies: one
  stable ``torch.sort`` per key, last key first, each ascending or
  descending (``torch.sort(descending=True)``, not negation, which
  overflows at the int64 minimum and flips -0.0). Float keys compare as
  the reference's ``<`` does: -0.0 ties +0.0; NaN, which the reference's
  network cannot order, sorts above +inf, where ``torch.sort`` and the
  CUDA encoding both put it.
* :func:`segmented_scan` — the reference's Hillis–Steele segmented
  inclusive scan, step for step.
"""

from __future__ import annotations

import torch


def lexsort_order(keys: list, directions: list | None = None):
    """Stable lexicographic order of rows by ``keys`` (first key most
    significant), each ascending (+1, the default) or descending (-1);
    ties keep row order, as ``np.lexsort(keys[::-1])``."""
    dirs = list(directions or []) + [1] * (len(keys) - len(directions or []))
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k, d in zip(reversed(keys), reversed(dirs)):
        k = k[order]
        if k.is_floating_point():
            k = k + 0.0                      # -0.0 becomes +0.0
        order = order[torch.sort(k, descending=d < 0, stable=True).indices]
    return order


def segmented_scan(vals, heads, combine, identity: float):
    """Segmented inclusive scan: ``heads`` marks segment starts; each
    row gets ``combine`` over its segment up to it, so a segment's total
    lands on its last row (log2 n shifted steps, as the reference)."""
    n = int(vals.shape[0])
    flag = heads.to(torch.bool)
    d = 1
    while d < n:
        shifted = torch.cat([torch.full((d,), identity, dtype=vals.dtype,
                                        device=vals.device), vals[:-d]])
        blocked = torch.cat([torch.ones((d,), dtype=torch.bool,
                                        device=flag.device), flag[:-d]])
        vals = torch.where(flag, vals, combine(vals, shifted))
        flag = flag | blocked
        d *= 2
    return vals
