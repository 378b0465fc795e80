"""Fused broadcast-join probe + aggregation — the port of
``repro.kernels.join_probe.fused_join_probe_agg``.

``join → [filter…] → partial_agg`` chains (TPC-H Q12/Q14/Q19) probe a PK
build side and aggregate at once: the joined relation is never written.
The build side comes sorted by key, masked rows last under the int64
sentinel, with its payload in the same order (the prepass of
``exec.lower``, as ``operators.make_pk_join_probe`` sorts it). Each probe
row lower-bound searches the sorted keys; it hits when the key found
equals its own, the row is valid and its key is not the sentinel. A
program with a probe-predicate slot (``Program.probe_slot``: the probe
side's own filters) has the kernel run it first, so only the rows it
passes are searched (queued per CTA in row order, 256 at a time). A hit
runs the rest of the expression program (the residual predicates, group
id, aggregate arguments) with the payload read at the hit's position,
and folds into the (A,) accumulator (ungrouped) or the (K, A+1) tile
with trailing presence counts; identities as
``segmented_minmax.init_group_tile``.

:func:`fused_join_probe_agg_cuda` launches ``csrc/join_probe.cu``;
:func:`fused_join_probe_agg_plain` is the same function in plain torch
(``torch.searchsorted`` and a gather, then the scan kernels' plain
folds), for CPU tensors and as the yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.roofline import JOIN_MAX_BUILD_ROWS, THREADS
from repro_torch.kernels import ext
from repro_torch.kernels.common import ACC_DTYPE, KEY_DTYPE
from repro_torch.kernels.filter_agg import fused_filter_agg_plain
from repro_torch.kernels.program import DTYPE_CODES, Program, eval_slot, \
    for_columns
from repro_torch.kernels.segmented_minmax import grouped_plain

NAME = "join_probe_agg"
INT64_SENTINEL = torch.iinfo(torch.int64).max
_KEY_TYPES = (torch.int64, torch.int32)


def _checked(probe_cols: dict, probe_mask, sorted_keys, probe_key: str):
    if sorted_keys.dtype != KEY_DTYPE or sorted_keys.dim() != 1 \
            or sorted_keys.numel() < 1:
        raise ValueError("sorted_keys must be a non-empty 1-D int64 tensor")
    key = probe_cols[probe_key]
    if key.dtype not in _KEY_TYPES or key.shape != probe_mask.shape:
        raise TypeError(f"probe key {probe_key!r}: {key.dtype} "
                        f"{tuple(key.shape)}, want int64/int32 "
                        f"{tuple(probe_mask.shape)}")
    return key


def fused_join_probe_agg_plain(probe_cols: dict, probe_mask, sorted_keys,
                               sorted_payload: dict, *, probe_key: str,
                               program: Program) -> torch.Tensor:
    prog = for_columns(program, probe_cols, sorted_payload)
    pk = _checked(probe_cols, probe_mask, sorted_keys,
                  probe_key).to(KEY_DTYPE)
    pos = torch.searchsorted(sorted_keys, pk)
    pos_c = pos.clamp(0, sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos_c] == pk) & probe_mask & (pk != INT64_SENTINEL)
    cols = dict(probe_cols)
    for name, g in zip(prog.names, prog.gathered):
        if g:
            cols[name] = sorted_payload[name][pos_c]
    if prog.has_probe_pred:
        hit = hit & (eval_slot(prog, prog.probe_slot, cols) != 0)
    if prog.n_groups:
        return grouped_plain(cols, hit, prog)
    return fused_filter_agg_plain(cols, hit, program=prog)


def fused_join_probe_agg_cuda(probe_cols: dict, probe_mask, sorted_keys,
                              sorted_payload: dict, *, probe_key: str,
                              program: Program, tiling) -> torch.Tensor:
    lib = ext.library("join_probe")
    prog = for_columns(program, probe_cols, sorted_payload)
    dev = probe_mask.device
    key = _checked(probe_cols, probe_mask, sorted_keys, probe_key)
    B = int(sorted_keys.shape[0])
    if B > JOIN_MAX_BUILD_ROWS or sorted_keys.device != dev \
            or key.device != dev:
        raise ValueError(f"build side of {B} rows on {sorted_keys.device}: "
                         f"the kernel takes at most {JOIN_MAX_BUILD_ROWS} "
                         f"on {dev}")
    sk, key = sorted_keys.contiguous(), key.contiguous()
    cols, ptrs, types, n_cols = ext.column_args(
        probe_cols, probe_mask, prog, sorted_payload, B)
    gathered = sum(1 << j for j, g in enumerate(prog.gathered) if g)
    code, consts, slots, fns = prog.device_arrays(dev)
    A, K = prog.n_aggs, prog.n_groups
    n = int(probe_mask.shape[0])
    if n >= 2**31 or tiling.block_rows != THREADS:
        raise ValueError(f"{n} probe rows in blocks of {tiling.block_rows}: "
                         f"the kernel takes fewer than 2^31 rows in blocks "
                         f"of {THREADS}")
    ctas = ext.grid_ctas(tiling, n, dev)
    shape = (K, A + 1) if K else (A,)
    partials = torch.empty((ctas,) + shape, dtype=ACC_DTYPE, device=dev)
    out = torch.empty(shape, dtype=ACC_DTYPE, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.join_probe_launch(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(types,
                                                        ctypes.c_void_p),
        n_cols, gathered, probe_mask.data_ptr(), n, key.data_ptr(),
        DTYPE_CODES[key.dtype], sk.data_ptr(), B, code.data_ptr(),
        consts.data_ptr(), slots.data_ptr(), fns.data_ptr(), A,
        prog.probe_slot if prog.has_probe_pred else -1, K,
        partials.data_ptr(), out.data_ptr(), ctas, tiling.block_rows,
        stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    del cols
    return out
