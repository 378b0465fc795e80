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
from it how many CTAs fit on an SM, which fixes the grid. The scan
kernels (``filter_agg``, ``groupby_onehot``, ``segmented_minmax``) have
no tiling here: each program compiles into its own kernel, whose grid
follows its occupancy (``kernels.specialise``); the dispatch layer only
asks :func:`group_tile_fits` whether a grouped tile fits a block. The
Bloom probe has none either: its kernel takes a chunk of rows a warp and
sizes its grid from its own occupancy (``csrc/bloom.cu``).

The reference also kept the join's sorted build side and the Bloom
filter's words resident in VMEM and capped their size by it. Neither
fits a block's shared memory here (the SF-1 Q12 build side is 1.5 M
rows × 16 B ≈ 24 MB, the SF-1 filter 256 KiB): both kernels read them
from global memory through the 50 MB L2. So no memory budget caps the
join's build side; the kernel's own limit is its uint32 positions
(``JOIN_MAX_BUILD_ROWS``, and fewer than ``JOIN_MAX_PROBE_ROWS`` probe
rows), and its wrapper raises past it; the dispatch arm
(``exec/lower.py``) takes the generic join there, as the reference's arm
does past its cap.

The sort kernels (sort-aggregate, top-k) kept the whole batch resident
in VMEM, which capped the rows they took (``resident_sort_tiling``).
Here the radix sort runs in global memory and stages only blocks in
shared memory (:func:`sort_tiling`), so what caps the rows is the
kernels' int32 positions and segment counts (``SORT_MAX_ROWS``, the
largest power of two they hold), past which their wrappers raise and
their dispatch arms take the generic torch path, as the reference's do. A
top-k batch of at most 2^14 rows sorts in the shared memory of one
thread-block cluster instead (:func:`topk_block_rows`).

Constants: NVIDIA H100 SXM5 80 GB (data sheet and Hopper tuning guide):
132 SMs, 227 KB of shared memory usable by one block out of 228 KB per
SM, 2048 resident threads per SM, 3.35 TB/s HBM3, 34 TFLOP/s FP64 on
the CUDA cores (the kernels' accumulators are f64 and use no tensor
cores). A PCIe H100 has 114 SMs and 2.0 TB/s; the wrapper clamps the
grid to the SM count it finds, so only the balance point would move.
"""

from __future__ import annotations

import dataclasses
import math

H100_SXM = {
    "name": "H100 SXM5 80GB",
    "sm_count": 132,
    "smem_per_block": 232_448,      # 227 KB opt-in dynamic shared memory
    "smem_per_sm": 233_472,         # 228 KB
    "threads_per_sm": 2048,
    "hbm_bandwidth": 3.35e12,       # bytes/s
    "hbm_bytes": 80e9,              # HBM3 capacity
    "peak_fp64_flops": 34e12,       # CUDA-core FP64 (no tensor cores)
    # dense tensor-core and CUDA-core peaks, without sparsity (H100 SXM5
    # data sheet; the peaks PERF.md divides the kernels' operations by)
    "peak_bf16_flops": 989.4e12,
    "peak_tf32_flops": 494.7e12,
    "peak_fp32_flops": 66.9e12,
    # NVLink 4: 18 links, 900 GB/s both ways, 450 GB/s a direction a GPU,
    # 8 GPUs a node behind NVSwitch (HGX H100 data sheet)
    "nvlink_bandwidth": 450e9,
    "gpus_per_node": 8,
    # across nodes: one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7)
    "internode_bandwidth": 50e9,
}

THREADS = 256           # threads per CTA for every scan-aggregate kernel
_WARPS = THREADS // 32
_ACC_BYTES = 8          # f64 accumulators
_COL_BYTES = 8          # upper bound of one column lane (i64/f64)
_MASK_BYTES = 1         # bool validity mask
_SMEM_RESERVED = 1024   # per-CTA shared memory the runtime keeps
JOIN_MAX_BUILD_ROWS = 1 << 31   # the join kernel's uint32 build positions
JOIN_MAX_PROBE_ROWS = 1 << 31   # its int32 probe rows: fewer than this
SORT_MAX_ROWS = 1 << 30         # int32 positions and segment counts
SORT_MAX_LANES = 16             # sortnet.cuh kMaxLanes: invalid flag + keys
SORT_MAX_AGGS = 8               # sortnet.cuh kMaxScanAggs
SORT_MAX_TILE = 1 << 12         # rows of a radix block in shared memory
_LANE_BYTES = 8                 # one encoded u64 key lane
_POS_BYTES = 4                  # the int32 position
TOPK_BLOCK_THREADS = 256        # block_sort.cuh kBlockThreads: a CTA
TOPK_CTA_ROWS = 1024            # kCtaRows: rows a CTA of the cluster holds
TOPK_CLUSTER_CTAS = 16          # kClusterMax: Hopper's largest cluster
_TOPK_ROW_BITS = 14             # kInvBit: a row index below the flag


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


def _warp_partials_bytes(n_aggs: int) -> int:
    """Shared memory of the ungrouped reduction: A f64 per warp."""
    return _WARPS * max(n_aggs, 1) * _ACC_BYTES


def group_tile_bytes(n_groups: int, n_aggs: int) -> int:
    """Shared memory of one CTA's (K, A+1) f64 group tile."""
    return max(n_groups, 1) * (n_aggs + 1) * _ACC_BYTES


def group_tile_fits(n_groups: int, n_aggs: int) -> bool:
    return group_tile_bytes(n_groups, n_aggs) <= smem_budget_bytes()


def join_probe_tiling(*, n_cols: int, n_payload: int, n_aggs: int,
                      n_groups: int) -> KernelTiling:
    """Fused join probe + aggregation: one thread per probe row binary-
    searches the sorted build keys in global memory (L2-resident at
    SF 1), gathers the payload of its hit, and folds into the grouped
    tile or the per-thread accumulators of the scan kernels. The build
    side does not bound the grid."""
    smem = (group_tile_bytes(n_groups, n_aggs) if n_groups
            else _warp_partials_bytes(n_aggs))
    # log2(B) search compares at the cap, the expression program, the
    # aggregate update
    flops = (2.0 * math.log2(JOIN_MAX_BUILD_ROWS) + 2.0 * (n_aggs + 1)
             + 2.0 * n_cols)
    bpr = float((n_cols + 1) * _COL_BYTES + _MASK_BYTES
                + n_payload * _COL_BYTES)
    return _finish("join_probe_agg", smem, flops, bpr)


def sort_tiling(kernel: str, *, n_keys: int) -> KernelTiling:
    """The LSD radix sort of ``sort_agg`` and ``topk`` (``csrc/
    sortnet.cuh``) over the invalid flag and ``n_keys`` keys, each an
    8-byte lane, plus the int32 position.

    ``block_rows`` is the rows of a radix block (a histogram and a
    scatter block): the largest power of two, at most ``SORT_MAX_TILE``,
    whose lanes fit half an SM's shared memory (two blocks per SM; a
    scatter block stages 12 bytes a row of it, 48 KB at 2^12 rows).
    ``resident_rows`` is what the kernels accept, ``SORT_MAX_ROWS``.
    The estimates are per row and per live 8-bit digit pass: the digit's
    extraction and its rank, and the scatter's read and write of the
    8-byte value and the 4-byte position."""
    lanes = 1 + max(n_keys, 0)
    row = lanes * _LANE_BYTES + _POS_BYTES
    fit = (H100_SXM["smem_per_sm"] // 2 - _SMEM_RESERVED) // row
    block = _pow2_floor(max(min(SORT_MAX_TILE, fit), 2))
    flops = 4.0
    bpr = 2.0 * (_LANE_BYTES + _POS_BYTES)
    ai = flops / bpr
    dominant = "compute" if ai >= machine_balance() else "memory"
    return KernelTiling(kernel, block, SORT_MAX_ROWS, block * row, flops,
                        bpr, ai, dominant)


def topk_block_rows(n_keys: int) -> int:
    """Largest capacity the top-k sorts in one launch of one thread-block
    cluster (``csrc/block_sort.cuh``), with ``n_keys`` sort keys; the
    top-k takes larger batches with the radix sort of :func:`sort_tiling`.
    Each CTA of the cluster holds the permutation entries of
    ``TOPK_CTA_ROWS`` rows and the current lane's encoded value of every
    row in shared memory (8 bytes a row whatever the number of keys: a
    lane is re-encoded from its column when the sort reaches it; 142 KB
    a CTA at 2^14 rows with the digit counts), and a permutation entry
    packs the row in ``_TOPK_ROW_BITS`` bits: 16 CTAs × 1024 = 2^14
    rows, TPC-H Q3's final at SF 1. 0 for a key count the kernels do not
    take."""
    if not 1 <= n_keys < SORT_MAX_LANES:
        return 0
    return min(TOPK_CLUSTER_CTAS * TOPK_CTA_ROWS, 1 << _TOPK_ROW_BITS)


def onehot_group_capacity(n_aggs: int = 4) -> int:
    """Largest group domain K the grouped kernels accept: the (K, A+1)
    f64 tile must fit one block's shared memory. Replaces the
    reference's VMEM-derived cap (4096 there; 4096 here at A = 4)."""
    lane = (n_aggs + 1) * _ACC_BYTES
    return _pow2_floor(max(smem_budget_bytes() // lane, 1))


def model_flops(cfg, shape, *, train: bool) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) global step FLOPs; 2·N·D for
    forward-only kinds (the reference's ``roofline.model_flops``)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if train else 2
    return mult * n * tokens
