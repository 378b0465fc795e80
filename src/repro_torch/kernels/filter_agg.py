"""Fused filter + ungrouped aggregate — the port of
``repro.kernels.filter_agg.fused_filter_agg``.

The hot loop of a scan-heavy query worker (TPC-H Q6): evaluate the
predicate over the column block and fold the aggregates in one pass, with
no mask or filtered column ever written. :func:`fused_filter_agg_cuda`
launches the hand-written kernel (``csrc/filter_agg.cu``);
:func:`fused_filter_agg_plain` is the same function in plain torch, over
the same expression program, for CPU tensors and as the yardstick the
kernel is held against on the card.

Both return the (A,) float64 accumulator: sums and counts start at 0,
min at +inf and max at -inf (``common.NEUTRAL``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ext
from repro_torch.kernels.common import ACC_DTYPE, NEUTRAL
from repro_torch.kernels.program import Program, eval_slot, for_columns

NAME = "filter_agg"


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
    lib = ext.library(NAME)
    program = for_columns(program, columns)
    dev = mask.device
    cols, ptrs, types, n_cols = ext.column_args(columns, mask, program)
    code, consts, slots, fns = program.device_arrays(dev)
    A = program.n_aggs
    n = int(mask.shape[0])
    ctas = ext.grid_ctas(tiling, n, dev)
    partials = torch.empty((ctas, A), dtype=ACC_DTYPE, device=dev)
    out = torch.empty((A,), dtype=ACC_DTYPE, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.filter_agg_launch(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(types,
                                                        ctypes.c_void_p),
        n_cols, mask.data_ptr(), n, code.data_ptr(), consts.data_ptr(),
        slots.data_ptr(), fns.data_ptr(), A, partials.data_ptr(),
        out.data_ptr(), ctas, tiling.block_rows, stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    del cols
    return out
