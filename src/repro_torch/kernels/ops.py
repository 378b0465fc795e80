"""Public wrappers of the hand-written kernels: the fused query kernels
(scan-aggregate, join-probe and Bloom-probe, and the sort-aggregate and
top-k kernels over the radix sort of ``csrc/sortnet.cuh``), the
fixed-layout benchmark kernels (``filter_agg``, TPC-H Q6; ``groupby_onehot``)
and the model kernels (``flash_attention``, ``ssd_scan``); these four
keep the reference's signatures (``repro.kernels.ops``).

Each wrapper dispatches on the device of its inputs: CUDA tensors launch
the hand-written kernel, CPU tensors run its plain torch version. There
is no fallback between the two: a CUDA tensor that the kernel cannot
take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bloom as _bl
from repro_torch.kernels import filter_agg as _fa
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import groupby_onehot as _go
from repro_torch.kernels import join_probe as _jp
from repro_torch.kernels import segmented_minmax as _smm
from repro_torch.kernels import sort_agg as _sa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import topk as _tk
from repro_torch.kernels.program import Program


def _on_cuda(mask: torch.Tensor) -> bool:
    if mask.device.type == "cuda":
        return True
    if mask.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {mask.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = _flash.DEFAULT_BLOCK_Q,
                    block_k: int = _flash.DEFAULT_BLOCK_K):
    fn = _flash.flash_attention_cuda if _on_cuda(q) \
        else _flash.flash_attention_plain
    return fn(q, k, v, causal=causal, window=window, block_q=block_q,
              block_k=block_k)


def ssd_scan(x, dt, A_log, B, C, *, chunk: int = 128):
    fn = _ssd.ssd_scan_cuda if _on_cuda(x) else _ssd.ssd_scan_plain
    return fn(x, dt, A_log, B, C, chunk=chunk)


def filter_agg(shipdate, discount, quantity, extendedprice, *,
               date_lo: int, date_hi: int, disc_lo: float, disc_hi: float,
               qty_hi: float, block: int = _fa.BLOCK_ROWS):
    fn = _fa.filter_agg_cuda if _on_cuda(shipdate) else _fa.filter_agg_plain
    return fn(shipdate, discount, quantity, extendedprice, date_lo=date_lo,
              date_hi=date_hi, disc_lo=disc_lo, disc_hi=disc_hi,
              qty_hi=qty_hi, block=block)


def groupby_onehot(group_ids, values, *, n_groups: int,
                   block: int = _go.BLOCK_ROWS):
    fn = _go.groupby_onehot_cuda if _on_cuda(group_ids) \
        else _go.groupby_onehot_plain
    return fn(group_ids, values, n_groups=n_groups, block=block)


def fused_filter_agg(columns: dict, mask, *, program: Program, tiling):
    if _on_cuda(mask):
        return _fa.fused_filter_agg_cuda(columns, mask, program=program,
                                         tiling=tiling)
    return _fa.fused_filter_agg_plain(columns, mask, program=program)


def fused_groupby(columns: dict, mask, *, program: Program, tiling):
    if _on_cuda(mask):
        return _go.fused_groupby_cuda(columns, mask, program=program,
                                      tiling=tiling)
    return _go.fused_groupby_plain(columns, mask, program=program)


def fused_groupby_minmax(columns: dict, mask, *, program: Program, tiling):
    if _on_cuda(mask):
        return _smm.fused_groupby_minmax_cuda(columns, mask, program=program,
                                              tiling=tiling)
    return _smm.fused_groupby_minmax_plain(columns, mask, program=program)


def fused_join_probe_agg(probe_cols: dict, probe_mask, sorted_keys,
                         sorted_payload: dict, *, probe_key: str,
                         program: Program, tiling):
    if _on_cuda(probe_mask):
        return _jp.fused_join_probe_agg_cuda(
            probe_cols, probe_mask, sorted_keys, sorted_payload,
            probe_key=probe_key, program=program, tiling=tiling)
    return _jp.fused_join_probe_agg_plain(
        probe_cols, probe_mask, sorted_keys, sorted_payload,
        probe_key=probe_key, program=program)


def fused_bloom_filter(keys, mask, *, words, bits: int, k: int, tiling):
    if _on_cuda(mask):
        return _bl.fused_bloom_filter_cuda(keys, mask, words=words,
                                           bits=bits, k=k, tiling=tiling)
    return _bl.fused_bloom_filter_plain(keys, mask, words=words, bits=bits,
                                        k=k)


def fused_sort_agg(keys: list, values: list, fns: list, mask, *, tiling):
    if _on_cuda(mask):
        return _sa.fused_sort_agg_cuda(keys, values, fns, mask,
                                       tiling=tiling)
    return _sa.fused_sort_agg_plain(keys, values, fns, mask)


def fused_topk(columns: dict, mask, *, sort_keys: list, limit: int, tiling):
    if _on_cuda(mask):
        return _tk.fused_topk_cuda(columns, mask, sort_keys=sort_keys,
                                   limit=limit, tiling=tiling)
    return _tk.fused_topk_plain(columns, mask, sort_keys=sort_keys,
                                limit=limit)
