"""Oracles of the model and benchmark kernels (the port of
``repro.kernels.ref``), under the reference's names.

``ssd_scan_ref`` is the sequential float64 numpy recurrence, the oracle
the SSD scan and its plain version are held against. The other three
are the kernels' plain torch versions, so that each function has one
torch definition in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.filter_agg import filter_agg_plain
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as flash_attention_ref)
from repro_torch.kernels.groupby_onehot import groupby_onehot_plain


def ssd_scan_ref(x, dt, A_log, B, C) -> torch.Tensor:
    """Sequential SSD recurrence in float64 (the definitionally correct
    oracle). x: (batch, S, H, P); dt: (batch, S, H); A_log: (H,);
    B/C: (batch, S, N). Returns (batch, S, H, P) in x's dtype."""
    def f64(t):
        return t.detach().cpu().double().numpy()
    bsz, S, H, P = x.shape
    N = B.shape[-1]
    a = -np.exp(f64(A_log))
    xf, dtf, Bf, Cf = f64(x), f64(dt), f64(B), f64(C)
    y = np.zeros((bsz, S, H, P))
    state = np.zeros((bsz, H, N, P))
    for t in range(S):
        decay = np.exp(dtf[:, t] * a)                      # (b,H)
        upd = np.einsum("bn,bhp->bhnp", Bf[:, t], xf[:, t]) \
            * dtf[:, t][:, :, None, None]
        state = state * decay[:, :, None, None] + upd
        y[:, t] = np.einsum("bn,bhnp->bhp", Cf[:, t], state)
    return torch.from_numpy(y).to(device=x.device, dtype=x.dtype)


def filter_agg_ref(shipdate, discount, quantity, extendedprice, *,
                   date_lo, date_hi, disc_lo, disc_hi,
                   qty_hi) -> torch.Tensor:
    """TPC-H Q6's revenue, sum(extendedprice * discount) over the
    predicate, in float32: the first entry of the plain version."""
    return filter_agg_plain(shipdate, discount, quantity, extendedprice,
                            date_lo=date_lo, date_hi=date_hi,
                            disc_lo=disc_lo, disc_hi=disc_hi,
                            qty_hi=qty_hi)[0]


def groupby_agg_ref(group_ids, values, n_groups: int) -> torch.Tensor:
    """Grouped sums (n_groups, A); ids outside [0, n_groups) reach no
    group (as ``segment_sum`` drops them)."""
    return groupby_onehot_plain(group_ids, values, n_groups=n_groups)
