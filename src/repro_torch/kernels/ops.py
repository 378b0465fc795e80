"""Public wrappers of the fused scan-aggregate kernels.

Each wrapper dispatches on the device of its inputs: CUDA tensors launch
the hand-written kernel, CPU tensors run its plain torch version. There
is no fallback between the two: a CUDA tensor that the kernel cannot
take, a failed build or a failed launch raises.

The kernels of the reference that the port has not reached yet (join
probe, Bloom probe, sort-aggregate, top-k, and the benchmark and model
kernels) have no wrapper here; ``exec.lower`` reports their arms as not
yet ported.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import filter_agg as _fa
from repro_torch.kernels import groupby_onehot as _go
from repro_torch.kernels import segmented_minmax as _smm
from repro_torch.kernels.program import Program


def _on_cuda(mask: torch.Tensor) -> bool:
    if mask.device.type == "cuda":
        return True
    if mask.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {mask.device}")


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
