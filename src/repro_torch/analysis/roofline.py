"""Kernel tiling for the fused query kernels, from H100 budgets.

The tiling half of ``repro.analysis.roofline``: a pure function of the op
shape (column count, group domain, aggregate count) that picks the CUDA
launch shape of each fused kernel and records which side of the machine
balance it lands on. Being static, the tiling can join the compiled-
program cache key and be unit-tested without a card.

The reference sized Pallas row blocks against a quarter of the TPU's
VMEM. On Hopper a CTA streams rows grid-stride, so what the model sizes
is different: the per-CTA shared-memory working set (the (K, A+1) f64
group tile, or the per-warp partials of the ungrouped reduction), and
from it how many CTAs fit on an SM, which fixes the grid.

Constants: NVIDIA H100 SXM5 80 GB (data sheet and Hopper tuning guide):
132 SMs, 227 KB of shared memory usable by one block out of 228 KB per
SM, 2048 resident threads per SM, 3.35 TB/s HBM3, 34 TFLOP/s FP64 on
the CUDA cores (the kernels' accumulators are f64 and use no tensor
cores). A PCIe H100 has 114 SMs and 2.0 TB/s; the wrapper clamps the
grid to the SM count it finds, so only the balance point would move.
"""

from __future__ import annotations

import dataclasses

H100_SXM = {
    "name": "H100 SXM5 80GB",
    "sm_count": 132,
    "smem_per_block": 232_448,      # 227 KB opt-in dynamic shared memory
    "smem_per_sm": 233_472,         # 228 KB
    "threads_per_sm": 2048,
    "hbm_bandwidth": 3.35e12,       # bytes/s
    "peak_fp64_flops": 34e12,       # CUDA-core FP64 (no tensor cores)
}

THREADS = 256           # threads per CTA for every scan-aggregate kernel
_WARPS = THREADS // 32
_ACC_BYTES = 8          # f64 accumulators
_COL_BYTES = 8          # upper bound of one column lane (i64/f64)
_MASK_BYTES = 1         # bool validity mask
_SMEM_RESERVED = 1024   # per-CTA shared memory the runtime keeps


def machine_balance() -> float:
    """FLOPs per byte above which a kernel is FP64-bound rather than
    HBM-bound on the H100 SXM (about 10)."""
    return H100_SXM["peak_fp64_flops"] / H100_SXM["hbm_bandwidth"]


def smem_budget_bytes() -> int:
    return H100_SXM["smem_per_block"]


def _pow2_floor(n: int) -> int:
    return 1 << max(int(n).bit_length() - 1, 0)


@dataclasses.dataclass(frozen=True)
class KernelTiling:
    """Tiling chosen for one fused kernel instance.

    ``block_rows`` is the rows one CTA covers per grid-stride step (its
    thread count); ``resident_rows`` the rows the whole grid covers per
    step (CTAs × threads), so ``ctas`` is their ratio. ``smem_bytes`` is
    the per-CTA shared-memory working set. ``arithmetic_intensity`` and
    ``dominant`` record which side of the machine balance the kernel
    lands on.
    """
    kernel: str
    block_rows: int
    resident_rows: int
    smem_bytes: int
    flops_per_row: float
    bytes_per_row: float
    arithmetic_intensity: float
    dominant: str                # "compute" | "memory"

    @property
    def key(self) -> tuple:
        return (self.kernel, self.block_rows, self.resident_rows,
                self.smem_bytes)

    @property
    def ctas(self) -> int:
        return self.resident_rows // self.block_rows

    def as_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "block_rows": self.block_rows,
            "resident_rows": self.resident_rows,
            "smem_bytes": self.smem_bytes,
            "flops_per_row": round(self.flops_per_row, 3),
            "bytes_per_row": round(self.bytes_per_row, 3),
            "arithmetic_intensity": round(self.arithmetic_intensity, 4),
            "dominant": self.dominant,
        }


def _ctas_per_sm(smem_bytes: int) -> int:
    by_threads = H100_SXM["threads_per_sm"] // THREADS
    by_smem = H100_SXM["smem_per_sm"] // (smem_bytes + _SMEM_RESERVED)
    return max(1, min(by_threads, by_smem))


def _finish(kernel: str, smem: int, flops_per_row: float,
            bytes_per_row: float) -> KernelTiling:
    ai = flops_per_row / max(bytes_per_row, 1e-9)
    dominant = "compute" if ai >= machine_balance() else "memory"
    ctas = H100_SXM["sm_count"] * _ctas_per_sm(smem)
    return KernelTiling(kernel, THREADS, ctas * THREADS, int(smem),
                        flops_per_row, bytes_per_row, ai, dominant)


def filter_agg_tiling(*, n_cols: int, n_aggs: int) -> KernelTiling:
    """scan→filter→agg: each thread folds its rows into A registers; the
    CTA reduces per-warp partials through shared memory."""
    smem = _WARPS * max(n_aggs, 1) * _ACC_BYTES
    flops = 4.0 * n_aggs + 2.0 * n_cols          # pred eval + accumulate
    bpr = float(n_cols * _COL_BYTES + _MASK_BYTES)
    return _finish("filter_agg", smem, flops, bpr)


def group_tile_bytes(n_groups: int, n_aggs: int) -> int:
    """Shared memory of one CTA's (K, A+1) f64 group tile."""
    return max(n_groups, 1) * (n_aggs + 1) * _ACC_BYTES


def group_tile_fits(n_groups: int, n_aggs: int) -> bool:
    return group_tile_bytes(n_groups, n_aggs) <= smem_budget_bytes()


def groupby_tiling(kernel: str, *, n_cols: int, n_aggs: int,
                   n_groups: int) -> KernelTiling:
    """Grouped aggregation (sum/count, plus min/max for
    ``segmented_minmax``): one shared-memory (K, A+1) f64 tile per CTA,
    updated with shared atomics. The tile fixes how many CTAs fit on an
    SM."""
    smem = group_tile_bytes(n_groups, n_aggs)
    flops = 2.0 * (n_aggs + 1) + 2.0 * n_cols    # pred/gid eval + update
    bpr = float(n_cols * _COL_BYTES + _MASK_BYTES)
    return _finish(kernel, smem, flops, bpr)


def onehot_group_capacity(n_aggs: int = 4) -> int:
    """Largest group domain K the grouped kernels accept: the (K, A+1)
    f64 tile must fit one block's shared memory. Replaces the
    reference's VMEM-derived cap (4096 there; 4096 here at A = 4)."""
    lane = (n_aggs + 1) * _ACC_BYTES
    return _pow2_floor(max(smem_budget_bytes() // lane, 1))
