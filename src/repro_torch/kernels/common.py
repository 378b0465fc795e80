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


def true_divide(a, b):
    """``a / b`` with the reference's result type and rounding — the one
    rule for the generic operators (``exec.expr``) and the kernel
    programs' type pass (``kernels.program``, on proxy tensors).

    Two integer operands divide in float64 when they promote to int64,
    else in float32 (jnp: ``int32 / 7`` is float32). A 0-dim divisor
    under a column (a literal) multiplies by its reciprocal, taken in
    the result type: the reference's fragment programs are jitted, and
    XLA rewrites ``x / c`` so, which can differ from the quotient by an
    ulp."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if not a.is_floating_point() and not b.is_floating_point():
            wide = torch.result_type(a, b) == torch.int64
            dtype = torch.float64 if wide else torch.float32
            a, b = a.to(dtype), b.to(dtype)
        if divides_by_reciprocal(a, b):
            dtype = torch.result_type(a, b)
            return a.to(dtype) * reciprocal(b, dtype)
    return a / b


def divides_by_reciprocal(a, b) -> bool:
    """Whether :func:`true_divide` runs ``a / b`` as ``a * (1 / b)``."""
    return b.dim() == 0 < a.dim()


def reciprocal(b, dtype) -> torch.Tensor:
    """``1 / b`` taken in ``dtype``, the result type of the division."""
    return torch.ones((), dtype=dtype, device=b.device) / b.to(dtype)
