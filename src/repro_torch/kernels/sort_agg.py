"""Sort-strategy grouped aggregation — the port of
``repro.kernels.sort_agg.fused_sort_agg``.

A ``GROUP BY`` whose keys are not dictionary coded (``partial_agg`` over
a scan with strategy ``sort``) sorts the rows by ``[invalid] + keys``,
marks segment boundaries and reduces each segment, at the input's
capacity: segment s's keys, totals and mask land on output lane s, and
every lane past the last segment holds the identities (INT64_SENTINEL
keys, 0 sums and counts, ±inf min/max, a false mask). The output equals
``operators.make_sort_agg`` lane for lane.

The caller evaluates the predicate (folded into ``mask``), the int64
group keys and the f64 aggregate arguments on the generic torch ops
first, as the reference evaluates them outside its ``pallas_call``.
:func:`fused_sort_agg_cuda` launches ``csrc/sort_agg.cu`` (a radix sort
of the key lanes, ``csrc/sortnet.cuh``, then a segmented scan);
:func:`fused_sort_agg_plain` is the same function in plain torch (the
twins of ``kernels.sortnet``), for CPU tensors and as the yardstick on
the card.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.roofline import SORT_MAX_AGGS, SORT_MAX_LANES, \
    SORT_MAX_ROWS
from repro_torch.kernels import ext
from repro_torch.kernels.common import ACC_DTYPE, KEY_DTYPE, NEUTRAL
from repro_torch.kernels.program import AGG_CODES
from repro_torch.kernels.sortnet import lexsort_order, \
    radix_scratch_bytes, segmented_scan

NAME = "sort_agg"
INT64_SENTINEL = torch.iinfo(torch.int64).max
SCAN_TILE = 1024            # sortnet.cuh kScanTile: rows per scan block
_SCANS = {"sum": (torch.add, 0.0), "count": (torch.add, 0.0),
          "min": (torch.minimum, float("inf")),
          "max": (torch.maximum, float("-inf"))}


def _checked(keys: list, values: list, fns: list, mask):
    ext.check_mask(mask)
    n = int(mask.shape[0])
    if n < 1 or n & (n - 1):
        raise ValueError(f"sort_agg needs a power-of-two capacity: {n}")
    if len(values) != len(fns) or not set(fns) <= set(AGG_CODES):
        raise ValueError(f"aggregates {fns} with {len(values)} values")
    for k in keys:
        if k.dtype != KEY_DTYPE or tuple(k.shape) != (n,) \
                or k.device != mask.device:
            raise ValueError(f"group key {k.dtype} {tuple(k.shape)} on "
                             f"{k.device}: want int64 ({n},) on "
                             f"{mask.device}")
    for v, fn in zip(values, fns):
        if fn != "count" and (v is None or v.dtype != ACC_DTYPE
                              or tuple(v.shape) != (n,)
                              or v.device != mask.device):
            raise ValueError(f"{fn} argument: want float64 ({n},) on "
                             f"{mask.device}")
    return n


def fused_sort_agg_plain(keys: list, values: list, fns: list, mask):
    """``(out_keys, out_values, out_mask)`` at the input's capacity."""
    n = _checked(keys, values, fns, mask)
    dev = mask.device
    inv = (~mask).to(torch.int32)
    order = lexsort_order([inv] + keys)
    s_keys = [k[order] for k in keys]
    s_mask = mask[order]
    diff = torch.zeros((n - 1,), dtype=torch.bool, device=dev)
    for k in [inv[order]] + s_keys:
        diff = diff | (k[1:] != k[:-1])
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    heads = torch.cat([one, diff])
    is_last = torch.cat([diff, one])
    dest = (torch.cumsum(heads, 0) - 1)[is_last]
    last_valid = (is_last & s_mask)[is_last]
    out_keys = []
    for k in s_keys:
        o = torch.full((n,), INT64_SENTINEL, dtype=KEY_DTYPE, device=dev)
        o[dest] = torch.where(last_valid, k[is_last], INT64_SENTINEL)
        out_keys.append(o)
    maskf = s_mask.to(ACC_DTYPE)
    out_vals = []
    for v, fn in zip(values, fns):
        x = maskf if fn == "count" else v[order]
        combine, ident = _SCANS[fn]
        if fn in ("sum", "count"):
            x = x * maskf
        else:
            x = torch.where(s_mask, x, ident)
        o = torch.full((n,), NEUTRAL[fn], dtype=ACC_DTYPE, device=dev)
        o[dest] = segmented_scan(x, heads, combine, ident)[is_last]
        out_vals.append(o)
    out_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    out_mask[dest] = last_valid
    return out_keys, out_vals, out_mask


def fused_sort_agg_cuda(keys: list, values: list, fns: list, mask, *,
                        tiling):
    lib = ext.library("sort_agg")
    n = _checked(keys, values, fns, mask)
    dev = mask.device
    if n > SORT_MAX_ROWS or len(keys) + 1 > SORT_MAX_LANES \
            or len(fns) > SORT_MAX_AGGS:
        raise ValueError(f"sort_agg takes at most {SORT_MAX_ROWS} rows, "
                         f"{SORT_MAX_LANES - 1} keys and {SORT_MAX_AGGS} "
                         f"aggregates: {n}, {len(keys)}, {len(fns)}")
    keys = [k.contiguous() for k in keys]
    values = [None if fn == "count" else v.contiguous()
              for v, fn in zip(values, fns)]
    A, nb = len(fns), -(-n // SCAN_TILE)
    lanes = torch.empty((len(keys) + 1, n), dtype=torch.int64, device=dev)
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    nbytes = radix_scratch_bytes(n, len(keys) + 1, tiling.block_rows)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    aux_v = torch.empty((max(A, 1) * nb,), dtype=ACC_DTYPE, device=dev)
    aux_i = torch.empty((2 * nb + 1,), dtype=torch.int32, device=dev)
    out_keys = torch.empty((len(keys), n), dtype=KEY_DTYPE, device=dev)
    out_vals = torch.empty((A, n), dtype=ACC_DTYPE, device=dev)
    out_mask = torch.empty((n,), dtype=torch.bool, device=dev)
    codes = ext.int_array([AGG_CODES[f] for f in fns])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.sort_agg_launch(
        mask.data_ptr(), n, ext.ptr_array(keys), len(keys), ext.ptr_array(values),
        codes, A, ext.ptr_array(list(lanes)),
        pos.data_ptr(), tiling.block_rows, scratch.data_ptr(), nbytes,
        aux_v.data_ptr(),
        aux_i.data_ptr(), ext.ptr_array(list(out_keys)),
        ext.ptr_array(list(out_vals)), out_mask.data_ptr(), stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    return list(out_keys), list(out_vals), out_mask
