"""Mamba2 SSD chunked scan — the port of
``repro.kernels.ssd_scan.ssd_scan``.

x (batch, S, H, P); dt (batch, S, H), softplus'd; A_log (H,); B/C
(batch, S, N), shared by the heads. Returns y (batch, S, H, P). Per chunk
of ``min(chunk, S)`` tokens: a masked-decay (Q, Q) term within the chunk
plus the (N, P) float32 state carried in from the chunks before it.
Positions past S act as dt = 0 padding (no decay, no update), as the
reference pads.

:func:`ssd_scan_cuda` launches the hand-written kernel
(``csrc/ssd_scan.cu``: one CTA per (batch, head) looping over the chunks,
the state in shared memory, the (Q, Q) tile in 64-row strips; float32,
P 64, N 16/32/64/128). :func:`ssd_scan_plain` is the same chunk loop in
plain torch, with C·Bᵀ formed once per (batch, chunk) for every head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ext

NAME = "ssd_scan"
HEAD_DIM = 64
STATE_SIZES = (16, 32, 64, 128)
MAX_CHUNK = 1024


def _check_shapes(x, dt, A_log, B, C) -> tuple[int, int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"x: want (batch, S, H, P), got {tuple(x.shape)}")
    bsz, S, H, P = x.shape
    if tuple(dt.shape) != (bsz, S, H) or tuple(A_log.shape) != (H,) \
            or B.dim() != 3 or tuple(B.shape[:2]) != (bsz, S) \
            or C.shape != B.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A_log {tuple(A_log.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)} do not fit")
    return bsz, S, H, P, int(B.shape[-1])


def ssd_scan_plain(x, dt, A_log, B, C, *, chunk: int = 128) -> torch.Tensor:
    """The function of :func:`ssd_scan_cuda` in plain torch (float32
    math, the result in x's dtype)."""
    bsz, S, H, P, N = _check_shapes(x, dt, A_log, B, C)
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).transpose(1, 2)    # (b,H,Sp)
    Bf = F.pad(B.float(), (0, 0, 0, pad))
    Cf = F.pad(C.float(), (0, 0, 0, pad))
    a = -torch.exp(A_log.float())
    da = dtf * a[None, :, None]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, H, N, P), dtype=torch.float32,
                        device=x.device)
    y = torch.empty((bsz, H, nc * Q, P), dtype=torch.float32,
                    device=x.device)
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc, Bc, Cc = xf[:, :, sl], dtf[:, :, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(da[:, :, sl], dim=-1)                # (b,H,Q)
        total = cum[..., -1:]                                   # (b,H,1)
        cb = torch.matmul(Cc, Bc.transpose(1, 2))[:, None]      # (b,1,Q,Q)
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])
        w = torch.where(tri, cb * decay * dtc[..., None, :], 0.0)
        y_intra = torch.matmul(w, xc)                           # (b,H,Q,P)
        y_inter = torch.matmul(Cc[:, None], state) * torch.exp(cum)[..., None]
        y[:, :, sl] = y_intra + y_inter
        wb = Bc[:, None] * (torch.exp(total - cum) * dtc)[..., None]
        state = state * torch.exp(total)[..., None] + torch.matmul(
            wb.transpose(-1, -2), xc)
    return y[:, :, :S].permute(0, 2, 1, 3).to(x.dtype)


def ssd_scan_cuda(x, dt, A_log, B, C, *, chunk: int = 128) -> torch.Tensor:
    """The kernel. Takes contiguous float32 CUDA tensors with P = 64 and
    N in (16, 32, 64, 128), and a chunk of at most 1024 tokens; raises on
    anything else."""
    bsz, S, H, P, N = _check_shapes(x, dt, A_log, B, C)
    tensors = {"x": x, "dt": dt, "A_log": A_log, "B": B, "C": C}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous float32 tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if P != HEAD_DIM or N not in STATE_SIZES:
        raise ValueError(f"P {P}, N {N}: the kernel takes P {HEAD_DIM} and "
                         f"N in {STATE_SIZES}")
    Q = min(chunk, S)
    if not 1 <= Q <= MAX_CHUNK or bsz * H >= 2**31:
        raise ValueError(f"chunk {Q}, batch·heads {bsz * H}: out of range")
    lib = ext.library(NAME)
    y = torch.empty_like(x)
    rc = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), bsz, S, H, P, N, Q,
        torch.cuda.current_stream(x.device).cuda_stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    return y
