"""Mamba2 state-space duality (SSD) layer — the port of
``repro.models.ssm``: the chunked scan formulation (arXiv:2405.21060) and
the constant-state single-token decode step.

The chunked algorithm splits the sequence into chunks of Q tokens:
intra-chunk terms form a small attention-like quadratic within each chunk
(the hand-written kernel ``repro_torch.kernels.ops.ssd_scan`` computes
the same function on the card), and inter-chunk terms propagate a
(heads, state, head_dim) running state. The reference combines the chunk
states with an associative scan (parallel over chunks); here an
exclusive loop over the chunks does it. Work is O(S·Q + S·N·P).

One difference: the intra-chunk decay masks before its exp, where the
reference masks after it. The forward values are the same; the
reference's gradient is NaN once a chunk's decay overflows float32 (a
chunk of 128 tokens at mamba2-130m's published widths), the port's is
finite (``tests/test_torch_train_mixer.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, A_log, B, C, *, chunk: int) -> torch.Tensor:
    """SSD forward.

    x:  (batch, S, H, P)    inputs per head
    dt: (batch, S, H)       softplus-activated step sizes (>0)
    A_log: (H,)             log of -A (per-head decay rate)
    B:  (batch, S, N)       input projection (ngroups=1, shared over heads)
    C:  (batch, S, N)       output projection
    returns y: (batch, S, H, P)
    """
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    orig_S = S
    if S % Q:
        # pad with dt=0 tokens: zero step size contributes nothing to
        # states and padded outputs are sliced off below
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    a = -torch.exp(A_log.float())                       # (H,) negative

    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = B.reshape(Bsz, nc, Q, N)
    Cc = C.reshape(Bsz, nc, Q, N)

    # log-decay within each chunk
    da = dtc * a                                        # (b,c,Q,H)
    cum = torch.cumsum(da, dim=2)                       # inclusive
    seg_total = cum[:, :, -1, :]                        # (b,c,H)

    # intra-chunk (masked quadratic). The mask goes inside the exp: above
    # the diagonal cum_s - cum_t is the positive sum of |dt·a| over
    # (s, t], whose exp overflows float32 once it passes about 88 (a
    # chunk of 128 tokens at mamba2-130m's published widths), and the
    # reference's where-after-exp then turns the backward pass's
    # 0 · inf into NaN. The forward values are the same either way.
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(
        causal[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))
    cb = torch.einsum("bcsn,bctn->bcst", Cc.float(), Bc.float())
    w = cb[..., None] * decay * dtc[:, :, None, :, :]   # (b,c,s,t,H)
    y_intra = torch.einsum("bcsth,bcthp->bcshp", w, xc)

    # chunk states: S_c = Σ_t exp(cum_last - cum_t) dt_t B_t ⊗ x_t
    sdecay = torch.exp(seg_total[:, :, None, :] - cum)  # (b,c,Q,H)
    wB = Bc[:, :, :, None, :] * (sdecay * dtc)[..., None]  # (b,c,Q,H,N)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp", wB, xc)

    # the state entering chunk k: S_k = a_k·S_{k-1} + b_k, exclusive
    a_seg = torch.exp(seg_total)                        # (b,c,H)
    prev = torch.zeros_like(chunk_state[:, 0])
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = a_seg[:, c, :, None, None] * prev + chunk_state[:, c]
    prev_states = torch.stack(prev_states, dim=1)       # (b,c,H,N,P)

    # inter-chunk output: y_s += exp(cum_s) · C_s · S_prev
    out_decay = torch.exp(cum)                          # (b,c,Q,H)
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc.float(),
                           prev_states) * out_decay[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :orig_S]
    return y.to(x.dtype)


def ssd_decode_step(state, x, dt, A_log, B, C):
    """Single-token recurrence.

    state: (batch, H, N, P); x: (batch, H, P); dt: (batch, H);
    B/C: (batch, N). Returns (y (batch, H, P), new_state).
    """
    a = -torch.exp(A_log.float())
    dtf = dt.float()
    decay = torch.exp(dtf * a)                          # (b,H)
    upd = torch.einsum("bn,bhp->bhnp", B.float(), x.float()) \
        * dtf[:, :, None, None]
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C.float(), new_state)
    return y.to(x.dtype), new_state


def causal_conv(x, w, conv_state=None):
    """Depthwise causal conv1d, width K. x: (B, S, D); w: (K, D).

    With ``conv_state`` (B, K-1, D) performs the streaming update and
    returns (y (B, S, D), new_state)."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros_like(x[:, :K - 1])
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + x.shape[1]] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y, new_state
