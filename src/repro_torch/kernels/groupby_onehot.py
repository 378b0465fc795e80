"""Fused filter + grouped sum/count (TPC-H Q1) — the port of
``repro.kernels.groupby_onehot.fused_groupby``.

For group keys with a small known domain K (Q1: returnflag × linestatus,
K = 6) the reference turned grouped sums into a one-hot matmul on the
MXU. The Hopper kernel keeps the same (K, A+1) contract with the
one-hot done in registers: each program compiles into its own kernel
(:mod:`repro_torch.kernels.specialise`, ``csrc/scan_spec.cuh``), whose
threads fold each row into a (K, A+1) register tile by a select over
the groups where the tile is small, or into a shared-memory tile; see
:mod:`repro_torch.kernels.segmented_minmax` for the contract and the
shared launch and plain helpers. Only ``sum`` and ``count`` aggregates
run here.

:func:`groupby_onehot_cuda` / :func:`groupby_onehot_plain` are the
fixed-layout benchmark kernel (``groupby_onehot``): float32 grouped sums
of an (n, A) matrix by an int32 group id, (K, A) out
(``csrc/groupby_onehot.cu``), each thread's tile in registers where K·A
<= ``REGISTER_TILE``, else a tile per warp in shared memory
(:func:`onehot_layout`); both sum in a fixed order, so a call repeats
bit for bit. A group id outside [0, K) reaches no group,
as its one-hot row is all zero in the reference. (The reference's matmul
also spreads a NaN value to every group, 0 · NaN; here it reaches only
its own.)
"""

from __future__ import annotations

import torch

from repro_torch.analysis.roofline import smem_budget_bytes
from repro_torch.kernels import ext
from repro_torch.kernels.program import Program
from repro_torch.kernels.segmented_minmax import grouped_plain, launch_grouped

NAME = "groupby"
NAME_ONEHOT = "groupby_onehot"
BLOCK_ROWS = 1024        # the reference's tile; the CUDA kernel picks its own
THREADS = 256            # the partials: at most a CTA per THREADS rows
CTAS_PER_SM = 8          # and CTAS_PER_SM an SM (the kernel may take fewer)
REGISTER_TILE = 64       # csrc kRegTile: K·A up to this in registers
MAX_WARPS = 8            # csrc kMaxWarps: per-warp tiles a CTA


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


# -- the fixed-layout kernel (``groupby_onehot``) -----------------------------

def groupby_onehot_plain(group_ids, values, *, n_groups: int,
                         block: int = BLOCK_ROWS) -> torch.Tensor:
    """group_ids (n,) taken as int32, values (n, A) as float32; returns
    (n_groups, A) float32 grouped sums. As the reference, rows are summed
    per block of ``block`` rows first and the block sums then folded."""
    gid = group_ids.to(torch.int32)
    vals = values.to(torch.float32)
    n, A = vals.shape
    block = min(block, max(n, 8))
    ok = (gid >= 0) & (gid < n_groups)
    rows = torch.arange(n, device=vals.device)
    slot = (rows // block) * n_groups + gid.long()
    nb = -(-n // block)
    sums = torch.zeros((nb * n_groups, A), dtype=torch.float32,
                       device=vals.device)
    sums.index_add_(0, slot[ok], vals[ok])
    return sums.view(nb, n_groups, A).sum(0)


def onehot_layout(n_groups: int, n_cols: int) -> tuple[str, int]:
    """The kernel's path for a (K, A) tile and its warps a CTA:
    ``("registers", 8)`` where K·A <= ``REGISTER_TILE`` (each thread's tile
    in registers), else ``("warps", w)``: one (K, A) float32 tile per warp
    in shared memory, for as many warps as fit one block's shared memory,
    at most ``MAX_WARPS``. Raises where not even one tile fits."""
    K, A = int(n_groups), int(n_cols)
    if A < 1 or K < 1:
        raise ValueError(f"({K}, {A}) tile: want K >= 1 and A >= 1")
    if K * A <= REGISTER_TILE:
        return "registers", MAX_WARPS
    fit = smem_budget_bytes() // (4 * K * A)
    if fit < 1:
        raise ValueError(f"({K}, {A}) float32 tile: want K * A * 4 <= "
                         f"{smem_budget_bytes()} bytes of shared memory")
    return "warps", min(MAX_WARPS, fit)


def groupby_onehot_cuda(group_ids, values, *, n_groups: int,
                        block: int = BLOCK_ROWS) -> torch.Tensor:
    """The kernel of :func:`groupby_onehot_plain`. Takes a contiguous
    (n,) int32 and a contiguous (n, A) float32 CUDA tensor and raises on
    anything else, or where the (K, A) float32 tile exceeds one block's
    shared memory (:func:`onehot_layout`); ``block`` is accepted for the
    reference's signature."""
    del block
    n = int(group_ids.shape[0])
    if group_ids.dtype != torch.int32 or group_ids.dim() != 1 \
            or not group_ids.is_contiguous():
        raise ValueError(f"group_ids: want a contiguous 1-D int32 tensor, "
                         f"got {tuple(group_ids.shape)} {group_ids.dtype}")
    if values.dtype != torch.float32 or values.dim() != 2 \
            or values.shape[0] != n or not values.is_contiguous() \
            or values.device != group_ids.device:
        raise ValueError(f"values: want a contiguous ({n}, A) float32 "
                         f"tensor on {group_ids.device}, got "
                         f"{tuple(values.shape)} {values.dtype} on "
                         f"{values.device}")
    A, K = int(values.shape[1]), int(n_groups)
    path, warps = onehot_layout(K, A)
    lib = ext.library(NAME_ONEHOT)
    dev = group_ids.device
    ctas = max(1, min(ext.sm_count(dev) * CTAS_PER_SM, -(-n // THREADS)))
    partials = torch.empty((ctas, K, A), dtype=torch.float32, device=dev)
    out = torch.empty((K, A), dtype=torch.float32, device=dev)
    rc = lib.groupby_onehot_launch(
        group_ids.data_ptr(), values.data_ptr(), n, A, K,
        partials.data_ptr(), out.data_ptr(), ctas, warps,
        int(path == "registers"), torch.cuda.current_stream(dev).cuda_stream)
    ext.check(lib, rc, NAME_ONEHOT)
    ext.count_launch(NAME_ONEHOT)
    return out
