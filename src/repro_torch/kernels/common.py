"""Helpers shared by the generic operators and the fused kernels.

The single source of the accumulation policy and the aggregation
identities: the torch operator path
(``repro_torch.exec.operators``), the plain versions of the kernels and
the CUDA kernels must agree on these or their numerics diverge.

Accumulators are always float64 and keys always int64, on the CPU and on
the card. The reference narrowed them to f32/i32 on the TPU only because
Mosaic has no 64-bit lanes; Hopper has them. (The reference's
``pad_block`` has no counterpart: the CUDA kernels mask the ragged edge
of a block themselves, so nothing pads.)
"""

from __future__ import annotations

import torch

NEUTRAL = {"sum": 0.0, "count": 0.0, "min": float("inf"),
           "max": float("-inf")}

ACC_DTYPE = torch.float64
KEY_DTYPE = torch.int64
