"""Top-k selection for ORDER BY … LIMIT — the port of
``repro.kernels.topk.fused_topk``.

A final stage with sort keys and a limit (TPC-H Q3's) surfaces only
``limit`` rows, so the fragment sorts its batch by ``[invalid] + sort
keys`` (each ascending or descending, ties in row order) and keeps the
mask only on the first ``limit`` valid rows. Every column comes back in
sorted order at the input's capacity, in its own dtype: the reference
narrows to 32 bits only on the TPU. The coordinator's host sort still
runs on the surviving rows; the stable order makes the pre-selection
idempotent under it.

The caller folds the predicate into ``mask`` first.
:func:`fused_topk_cuda` launches ``csrc/topk.cu`` on one of two paths
(:func:`path`): up to ``roofline.topk_block_rows`` rows (TPC-H Q3's
final, capacity 2^14) one launch of one thread-block cluster (up to 16
CTAs of 1024 rows) sorts the batch in shared memory and gathers every
column (``csrc/block_sort.cuh``); above it the radix sort of
``csrc/sortnet.cuh`` in global memory, then one gather.
Both give the same permutation. :func:`fused_topk_plain` is the same
function in plain torch, for CPU tensors and as the yardstick on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.roofline import (SORT_MAX_LANES, SORT_MAX_ROWS,
                                          topk_block_rows)
from repro_torch.kernels import ext
from repro_torch.kernels.program import DTYPE_CODES
from repro_torch.kernels.sortnet import lexsort_order, radix_scratch_bytes

NAME = "topk"
CLUSTER, RADIX = "cluster", "radix"
GATHER_COLUMNS = 32      # topk.cu kMaxGather: columns a launch gathers


def path(n: int, n_keys: int) -> str:
    """The path :func:`fused_topk_cuda` takes for capacity ``n`` and
    ``n_keys`` sort keys: ``CLUSTER`` (one launch) up to
    ``roofline.topk_block_rows``, else ``RADIX``."""
    return CLUSTER if n <= topk_block_rows(n_keys) else RADIX


def _names(columns: dict, sort_keys: list) -> list:
    """Output column order, as the reference's: sort keys, then the rest."""
    keys = [name for name, _ in sort_keys]
    return keys + [c for c in columns if c not in keys]


def _checked(columns: dict, mask, sort_keys: list, limit: int) -> int:
    ext.check_mask(mask)
    n = int(mask.shape[0])
    if n < 1 or n & (n - 1):
        raise ValueError(f"topk needs a power-of-two capacity: {n}")
    if not sort_keys or limit < 0:
        raise ValueError(f"topk needs sort keys and a limit: {sort_keys}, "
                         f"{limit}")
    for name, c in columns.items():
        if tuple(c.shape) != (n,) or c.device != mask.device:
            raise ValueError(f"column {name!r}: {tuple(c.shape)} on "
                             f"{c.device}, want ({n},) on {mask.device}")
    return n


def fused_topk_plain(columns: dict, mask, *, sort_keys: list, limit: int):
    """``(out_columns, out_mask)`` at the input's capacity."""
    n = _checked(columns, mask, sort_keys, limit)
    inv = (~mask).to(torch.int32)
    order = lexsort_order([inv] + [columns[k] for k, _ in sort_keys],
                          [1] + [-1 if desc else 1 for _, desc in sort_keys])
    out = {c: columns[c][order] for c in _names(columns, sort_keys)}
    keep = torch.arange(n, device=mask.device) < limit
    return out, mask[order] & keep


def fused_topk_cuda(columns: dict, mask, *, sort_keys: list, limit: int,
                    tiling):
    lib = ext.library("topk")
    n = _checked(columns, mask, sort_keys, limit)
    dev = mask.device
    if n > SORT_MAX_ROWS or len(sort_keys) + 1 > SORT_MAX_LANES:
        raise ValueError(f"topk takes at most {SORT_MAX_ROWS} rows and "
                         f"{SORT_MAX_LANES - 1} sort keys: {n}, "
                         f"{len(sort_keys)}")
    names = _names(columns, sort_keys)
    src = [columns[c].contiguous() for c in names]
    for c, t in zip(names, src):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"column {c!r}: dtype {t.dtype} unsupported")
    keys = src[:len(sort_keys)]
    dst = [torch.empty_like(t) for t in src]
    out_mask = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key_args = (ext.ptr_array(keys),
                ext.int_array([DTYPE_CODES[k.dtype] for k in keys]),
                ext.int_array([int(desc) for _, desc in sort_keys]),
                len(keys))
    col_args = (ext.ptr_array(src), ext.ptr_array(dst),
                ext.int_array([t.element_size() for t in src]), len(src))
    if path(n, len(keys)) == CLUSTER:
        pos = torch.empty((n,), dtype=torch.int32, device=dev) \
            if len(src) > GATHER_COLUMNS else None
        rc = lib.topk_block_launch(
            mask.data_ptr(), n, *key_args, *col_args,
            pos.data_ptr() if pos is not None else None, int(limit),
            out_mask.data_ptr(), stream)
    else:
        lanes = torch.empty((len(keys) + 1, n), dtype=torch.int64,
                            device=dev)
        pos = torch.empty((n,), dtype=torch.int32, device=dev)
        nbytes = radix_scratch_bytes(n, len(keys) + 1, tiling.block_rows)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        rc = lib.topk_launch(
            mask.data_ptr(), n, *key_args, ext.ptr_array(list(lanes)),
            pos.data_ptr(), tiling.block_rows, scratch.data_ptr(), nbytes,
            *col_args, int(limit), out_mask.data_ptr(), stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    return dict(zip(names, dst)), out_mask
