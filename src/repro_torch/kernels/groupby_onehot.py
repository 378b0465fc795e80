"""Fused filter + grouped sum/count (TPC-H Q1) — the port of
``repro.kernels.groupby_onehot.fused_groupby``.

For group keys with a small known domain K (Q1: returnflag × linestatus,
K = 6) the reference turned grouped sums into a one-hot matmul on the
MXU. The Hopper kernel (``csrc/groupby.cu``) keeps the same (K, A+1)
contract with a shared-memory tile per CTA instead; see
:mod:`repro_torch.kernels.segmented_minmax` for the contract and the
shared launch and plain helpers. Only ``sum`` and ``count`` aggregates
run here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.program import Program
from repro_torch.kernels.segmented_minmax import grouped_plain, launch_grouped

NAME = "groupby"


def _check(program: Program) -> None:
    bad = set(program.fns) - {"sum", "count"}
    if bad:
        raise ValueError(f"fused_groupby takes sum/count only, got {bad}")


def fused_groupby_plain(columns: dict, mask, *,
                        program: Program) -> torch.Tensor:
    _check(program)
    return grouped_plain(columns, mask, program)


def fused_groupby_cuda(columns: dict, mask, *, program: Program,
                       tiling) -> torch.Tensor:
    _check(program)
    return launch_grouped(NAME, columns, mask, program, tiling)
