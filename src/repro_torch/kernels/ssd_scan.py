"""Mamba2 SSD chunked scan — the port of
``repro.kernels.ssd_scan.ssd_scan``.

x (batch, S, H, P); dt (batch, S, H), softplus'd; A_log (H,); B/C
(batch, S, N), shared by the heads. Returns y (batch, S, H, P). Per chunk
of ``min(chunk, S)`` tokens: a masked-decay (Q, Q) term within the chunk
plus the (N, P) float32 state carried in from the chunks before it.
Positions past S act as dt = 0 padding (no decay, no update), as the
reference pads.

:func:`ssd_scan_cuda` launches the hand-written kernel
(``csrc/ssd_scan.cu``: three phases that run every chunk in parallel,
the products on the TF32 tensor cores with each operand split in two
TF32 parts; float32, P 64, N 16/32/64/128). :func:`ssd_scan_plain` is
the chunk loop in plain torch, with C·Bᵀ formed once per (batch, chunk)
for every head. :func:`ssd_scan_phases` models the kernel's three
phases in plain torch, optionally with the products' operands cut to
TF32 as the tensor cores read them (``products``); nothing on the
card's path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ext

NAME = "ssd_scan"
HEAD_DIM = 64
STATE_SIZES = (16, 32, 64, 128)
MAX_CHUNK = 1024
STRIP = 64              # query rows of one phase-3 unit (csrc kTile)
PRODUCTS = ("float32", "one", "split")


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


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` as a TF32 operand of the tensor cores: its low 13
    mantissa bits cleared (the kernel's hi part clears them; the cores
    ignore them in a register they read as TF32)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """``a @ b`` in float32, or as the kernel's tensor cores take it:
    ``one`` product of the operands cut to TF32, or the ``split`` sum
    lo·hi + hi·lo + hi·hi of each operand's two TF32 parts (hi = tf32(v),
    lo = tf32(v - hi)); the products are exact in float32, the sums
    float32."""
    if products == "float32":
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if products == "one":
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_scan_phases(x, dt, A_log, B, C, *, chunk: int = 128,
                    products: str = "float32") -> torch.Tensor:
    """The kernel's three phases in plain torch (float32):
    1. per (batch, chunk, head): the cumsum of dt·a (in float64) and the
       chunk's own state Σ_t exp(cum_last - cum_t) dt_t B_tᵀ x_t, (N, P);
    2. per (batch, head), in order over the chunks: the state entering
       chunk c + 1, exp(cum_last) · state_c + local_c;
    3. per (batch, chunk): C·Bᵀ once, shared by the heads; per head the
       masked decay and dt, times x, plus exp(cum_s) C_s · state_c.
    ``products`` cuts each product's operands as the tensor cores do
    (see :func:`_mm`)."""
    if products not in PRODUCTS:
        raise ValueError(f"products {products!r}: want one of {PRODUCTS}")
    bsz, S, H, P, N = _check_shapes(x, dt, A_log, B, C)
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(
        bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)            # (b,c,H,Q,P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bsz, nc, Q, H).transpose(2, 3)                      # (b,c,H,Q)
    Bf = F.pad(B.float(), (0, 0, 0, pad)).reshape(bsz, nc, Q, N)
    Cf = F.pad(C.float(), (0, 0, 0, pad)).reshape(bsz, nc, Q, N)
    a = -torch.exp(A_log.float())
    # phase 1: cumsums (float64: each decay is a difference of two) and
    # each chunk's own state
    cum = torch.cumsum((dtf * a[:, None]).double(), dim=-1)  # (b,c,H,Q)
    total = cum[..., -1]                                    # (b,c,H)
    u = torch.exp((total[..., None] - cum).float()) * dtf
    local = _mm(Bf.transpose(-1, -2)[:, :, None], xf * u[..., None],
                products)                                   # (b,c,H,N,P)
    # phase 2: the state entering each chunk
    entering = torch.zeros_like(local)
    for c in range(nc - 1):
        entering[:, c + 1] = entering[:, c] * torch.exp(
            total[:, c].float())[..., None, None] + local[:, c]
    # phase 3: C·Bᵀ once per (batch, chunk), then each head's outputs
    cb = _mm(Cf, Bf.transpose(-1, -2), products)[:, :, None]  # (b,c,1,Q,Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).float())
    w = torch.where(tri, cb * decay * dtf[..., None, :], 0.0)
    y = _mm(w, xf, products) + _mm(Cf[:, :, None], entering, products) \
        * torch.exp(cum.float())[..., None]                 # (b,c,H,Q,P)
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, nc * Q, H, P)
    return y[:, :S].to(x.dtype)


def head_group(bsz: int, n_chunks: int, strips: int, H: int,
               sms: int) -> int:
    """Heads one phase-3 CTA handles (its C·Bᵀ is shared by them): all H,
    unless the (batch, chunk, strip) units make fewer than two waves on
    ``sms`` SMs; then as few heads as split them into enough groups."""
    units = bsz * n_chunks * strips
    groups = min(H, max(1, -(-2 * sms // units)))
    return -(-H // groups)


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
    nc = -(-S // Q)
    strips = -(-Q // STRIP)
    if not 1 <= Q <= MAX_CHUNK or bsz * nc * H * strips >= 2**31:
        raise ValueError(f"chunk {Q}, batch·chunks·heads {bsz * nc * H}: "
                         "out of range")
    group = head_group(bsz, nc, strips, H, ext.sm_count(x.device))
    lib = ext.library(NAME)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    # phase scratch: the states entering chunks 1..nc-1, and each
    # (batch, chunk, head)'s cumsum, dt and cumsum total
    states = torch.empty((bsz, max(nc - 1, 1), H, N, P), **f32)
    cum = torch.empty((bsz, nc, H, Q), dtype=torch.float64,
                      device=x.device)
    dtq = torch.empty((bsz, nc, H, Q), **f32)
    tot = torch.empty((bsz, nc, H), **f32)
    rc = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), states.data_ptr(), cum.data_ptr(),
        dtq.data_ptr(), tot.data_ptr(), bsz, S, H, P, N, Q, group,
        torch.cuda.current_stream(x.device).cuda_stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    return y
