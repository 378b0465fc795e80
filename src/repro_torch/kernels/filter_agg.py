"""Fused filter + ungrouped aggregate — the port of
``repro.kernels.filter_agg``'s two kernels.

The hot loop of a scan-heavy query worker (TPC-H Q6): evaluate the
predicate over the column block and fold the aggregates in one pass, with
no mask or filtered column ever written. :func:`fused_filter_agg_cuda`
launches the program's own kernel, compiled at first use
(:mod:`repro_torch.kernels.specialise`, ``csrc/scan_spec.cuh``);
:func:`fused_filter_agg_plain` is the same function in plain torch, over
the same expression program, for CPU tensors and as the yardstick the
kernel is held against on the card.

Both return the (A,) float64 accumulator: sums and counts start at 0,
min at +inf and max at -inf (``common.NEUTRAL``).

:func:`filter_agg_cuda` / :func:`filter_agg_plain` are the fixed-layout
benchmark kernel (``filter_agg``): TPC-H Q6's predicate over an int32
ship date and float32 discount, quantity and price, returning the (2,)
float32 ``[revenue, count]`` (``csrc/filter_agg_q6.cu``).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ext, specialise
from repro_torch.kernels.common import ACC_DTYPE, NEUTRAL
from repro_torch.kernels.program import Program, eval_slot, for_columns

NAME = "filter_agg"
NAME_Q6 = "filter_agg_q6"
BLOCK_ROWS = 2048        # the reference's tile; the CUDA kernel picks its own
THREADS = 256            # csrc/filter_agg_q6.cu kThreads
# the Q6 kernel's partials: room for as many CTAs as an SM's 2048 threads
# hold (the kernel launches what its occupancy fits, at most this)
MAX_CTAS_PER_SM = 2048 // THREADS
GROUP_ROWS = 4           # csrc/filter_agg_q6.cu kGroup: rows a thread a step


def _surviving(columns: dict, mask, prog: Program):
    m = mask
    if prog.has_pred:
        m = m & (eval_slot(prog, 0, columns) != 0)
    return m


def fused_filter_agg_plain(columns: dict, mask, *,
                           program: Program) -> torch.Tensor:
    program = for_columns(program, columns)
    m = _surviving(columns, mask, program)
    out = []
    for a, fn in enumerate(program.fns):
        if fn == "count":
            out.append(m.sum(dtype=ACC_DTYPE))
            continue
        v = eval_slot(program, 2 + a, columns).expand(mask.shape)
        ident = torch.tensor(NEUTRAL[fn], dtype=ACC_DTYPE,
                             device=mask.device)
        if fn == "sum":
            out.append(torch.where(m, v, 0.0).sum())
        elif v.numel() == 0:
            out.append(ident)
        elif fn == "min":
            out.append(torch.minimum(ident,
                                     torch.where(m, v, float("inf")).min()))
        else:
            out.append(torch.maximum(ident,
                                     torch.where(m, v, float("-inf")).max()))
    return torch.stack(out).to(ACC_DTYPE)


def fused_filter_agg_cuda(columns: dict, mask, *, program: Program,
                          tiling) -> torch.Tensor:
    """The program's compiled kernel (:mod:`.specialise`, skeleton
    ``filter_agg``). ``tiling`` is unused (the dispatch layer passes
    None): the grid follows the compiled kernel's occupancy."""
    del tiling
    return specialise.launch(NAME, columns, mask, program)


# -- the fixed-layout Q6 kernel (``filter_agg``) ------------------------------

def filter_agg_plain(shipdate, discount, quantity, extendedprice, *,
                     date_lo: int, date_hi: int, disc_lo: float,
                     disc_hi: float, qty_hi: float,
                     block: int = BLOCK_ROWS) -> torch.Tensor:
    """Columns are 1-D of equal length n; the ship date is taken as
    int32, the others as float32, as the reference casts them. The float
    bounds are rounded to float32 (JAX's weakly typed Python floats).
    Returns (2,) float32: [sum(price * discount), match count]."""
    del block                  # a tile size of the reference only
    ship = shipdate.to(torch.int32)
    disc = discount.to(torch.float32)
    qty = quantity.to(torch.float32)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=disc.device)
    m = ((ship >= int(date_lo)) & (ship < int(date_hi))
         & (disc >= f32(disc_lo)) & (disc <= f32(disc_hi))
         & (qty < f32(qty_hi)))
    val = torch.where(m, extendedprice.to(torch.float32) * disc, 0.0)
    return torch.stack([val.sum(), m.sum(dtype=torch.float32)])


def q6_layout(ptrs, n: int) -> tuple[bool, int, int]:
    """How ``csrc/filter_agg_q6.cu`` covers ``n`` rows of the columns at
    addresses ``ptrs``: ``(vector, groups, tail)``. The vector path loads
    a group of :data:`GROUP_ROWS` rows of each column as one 16-byte
    vector, so it needs every column 16-byte aligned at row 0; it then
    takes the ``n // GROUP_ROWS`` whole groups and the scalar loop the
    ``tail`` rows past them. Otherwise ``groups`` is 0 and the scalar
    loop takes every row."""
    vector = all(p % 16 == 0 for p in ptrs)
    groups = n // GROUP_ROWS if vector else 0
    return vector, groups, n - groups * GROUP_ROWS


_tickets: dict = {}
_tickets_lock = threading.Lock()


def _ticket(device, stream: int) -> torch.Tensor:
    """The Q6 kernel's CTA counter for ``stream`` on ``device``: one int32
    a stream, zeroed once on that stream, which the kernel leaves at 0
    again when it ends; so calls on one stream take it in turn and calls
    on two streams never share one."""
    key = (device.index, stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None:
            t = _tickets[key] = torch.zeros(1, dtype=torch.int32,
                                            device=device)
    return t


def filter_agg_cuda(shipdate, discount, quantity, extendedprice, *,
                    date_lo: int, date_hi: int, disc_lo: float,
                    disc_hi: float, qty_hi: float,
                    block: int = BLOCK_ROWS) -> torch.Tensor:
    """The kernel of :func:`filter_agg_plain`. Takes contiguous 1-D CUDA
    tensors, int32 ship date and float32 others, and raises on anything
    else; ``block`` is accepted for the reference's signature. The
    kernel takes a group of rows a thread (:func:`q6_layout`) and sizes
    its grid from its occupancy, and its last CTA folds the partials
    (:func:`_ticket`), in one launch; the count is exact, the revenue a
    float32 sum in a fixed order (two calls give the same bits)."""
    del block
    n = int(shipdate.shape[0])
    for name, t, dtype in (("shipdate", shipdate, torch.int32),
                           ("discount", discount, torch.float32),
                           ("quantity", quantity, torch.float32),
                           ("extendedprice", extendedprice, torch.float32)):
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous() or t.device != shipdate.device:
            raise ValueError(f"{name}: want a contiguous ({n},) {dtype} "
                             f"tensor on {shipdate.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    lo, hi = int(date_lo), int(date_hi)
    if not -2**31 <= lo <= hi < 2**31:
        raise ValueError(f"date bounds {lo}, {hi}: want int32")
    lib = ext.library(NAME_Q6)
    dev = shipdate.device
    cols = (shipdate, discount, quantity, extendedprice)
    _, groups, _ = q6_layout([c.data_ptr() for c in cols], n)
    max_ctas = ext.sm_count(dev) * MAX_CTAS_PER_SM
    partials = torch.empty((max_ctas, 2), dtype=torch.float32, device=dev)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.filter_agg_q6_launch(
        *(c.data_ptr() for c in cols), n, groups, lo, hi, float(disc_lo),
        float(disc_hi), float(qty_hi), partials.data_ptr(),
        _ticket(dev, stream).data_ptr(), out.data_ptr(), max_ctas, stream)
    ext.check(lib, rc, NAME_Q6)
    ext.count_launch(NAME_Q6)
    return out
