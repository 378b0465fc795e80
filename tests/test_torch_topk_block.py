"""The top-k's one-launch cluster path and the grouped sums' two paths,
without a card: which path each wrapper takes
(``roofline.topk_block_rows``, ``topk.path``,
``groupby_onehot.onehot_layout``), where the grouped sums' wrapper
raises, and the cluster sort's index arithmetic (``csrc/block_sort.cuh``:
each CTA's slice, each warp's chunk ranked 32 rows a step, the (digit,
CTA, warp) offsets, the scatter into the CTA that owns a position)
modelled step for step in numpy and held against ``lexsort_order``, the
order the reference's network gives. The kernels themselves run in
``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from repro_torch.analysis import roofline
from repro_torch.api import connect
from repro_torch.core import CoordinatorConfig
from repro_torch.core.engine import QueryEngine
from repro_torch.exec import lower
from repro_torch.exec.batch import bucket_capacity
from repro_torch.kernels import groupby_onehot as go
from repro_torch.kernels import sortnet
from repro_torch.kernels import topk as tk
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES

# the planner of the benchmark suites and of
# test_torch_sort.py::test_q3_final_runs_the_topk_arm_under_the_benchmark_planner
BENCH_PLANNER = dict(bytes_per_worker=500_000,
                     broadcast_threshold_bytes=250_000,
                     exchange_partitions=4)
Q3_FINAL_ROWS_SF1 = 11_522       # rows of Q3's final at SF 1 (PERF.md §4)

THREADS = roofline.TOPK_BLOCK_THREADS
WARPS = THREADS // 32
CTA_ROWS = roofline.TOPK_CTA_ROWS
BINS = sortnet.RADIX_BINS
INV_BIT = 14                     # block_sort.cuh kInvBit
ROW_MASK = (1 << INV_BIT) - 1


@pytest.fixture(scope="module")
def q3_final_op():
    s = connect(tier="local", quota=8, device="cpu")
    try:
        catalog = s.ensure_tpch(sf=0.01, n_parts=4)
        eng = QueryEngine(s.store, catalog, platform=s.platform,
                          config=CoordinatorConfig(planner=PlannerConfig(
                              **BENCH_PLANNER)), handler=s.handler)
        plan = eng.plan_sql(QUERIES["q3"])
    finally:
        s.close()
    (op,) = [p.op for p in plan.pipelines.values()
             if lower.kernel_info(p.op)["kernel"] == "topk"]
    return op


def test_q3_final_at_sf1_takes_the_cluster_path(q3_final_op):
    """Q3's final as the benchmark planner plans it (two sort keys:
    revenue descending, o_orderdate) at SF 1's capacity, 2^14."""
    n_keys = len(q3_final_op["sort_keys"])
    assert [k for k, _ in q3_final_op["sort_keys"]] == ["revenue",
                                                        "o_orderdate"]
    capacity = bucket_capacity(Q3_FINAL_ROWS_SF1)
    assert capacity == 1 << 14
    assert tk.path(capacity, n_keys) == tk.CLUSTER
    assert roofline.topk_block_rows(n_keys) >= capacity


@pytest.mark.parametrize("n_keys", [1, 2, 15])
def test_one_power_of_two_past_the_cap_takes_the_radix_path(n_keys):
    cap = roofline.topk_block_rows(n_keys)
    assert cap == 1 << 14
    assert tk.path(cap, n_keys) == tk.CLUSTER
    assert tk.path(1, n_keys) == tk.CLUSTER
    assert tk.path(2 * cap, n_keys) == tk.RADIX
    assert tk.path(roofline.SORT_MAX_ROWS, n_keys) == tk.RADIX


def test_cluster_cap_is_sixteen_ctas_of_1024_rows():
    """Hopper's largest thread-block cluster, 16 CTAs, each holding the
    permutation of 1024 rows and the lane's value of every row in shared
    memory (``block_sort_smem``: inside one block's budget at 2^14
    rows), which the 14 row bits of a permutation entry also cap; a key
    count the kernels do not take has no cluster path."""
    n = roofline.TOPK_CLUSTER_CTAS * CTA_ROWS
    assert n == 1 << 14 == roofline.topk_block_rows(2)
    smem = 8 * n + 4 * CTA_ROWS + (WARPS + 2) * BINS * 4
    assert smem + BINS * 4 + 32 * 4 + 2 * WARPS * 8 \
        <= roofline.H100_SXM["smem_per_block"]
    assert roofline.topk_block_rows(0) == 0
    assert roofline.topk_block_rows(roofline.SORT_MAX_LANES) == 0
    assert tk.path(1, 0) == tk.RADIX


@pytest.mark.parametrize("K,A,path", [
    (8, 8, "registers"), (13, 5, "warps"), (64, 1, "registers"),
    (65, 1, "warps"), (1, 64, "registers"), (1, 65, "warps"),
    (6, 5, "registers"), (120, 5, "warps"), (1, 1, "registers")])
def test_onehot_path_turns_at_k_times_a_64(K, A, path):
    """K·A <= 64 (Q1's 6 × 5 = 30): the register tile; 65 and up: a
    shared tile per warp, eight warps while eight fit."""
    got, warps = go.onehot_layout(K, A)
    assert K * A <= go.REGISTER_TILE if path == "registers" \
        else K * A > go.REGISTER_TILE
    assert (got, warps) == (path, go.MAX_WARPS)


def test_onehot_per_warp_tiles_shrink_to_what_fits_and_then_raise():
    budget = roofline.smem_budget_bytes()
    assert go.onehot_layout(budget // (4 * 3), 1) == ("warps", 3)
    assert go.onehot_layout(budget // 4, 1) == ("warps", 1)
    with pytest.raises(ValueError):
        go.onehot_layout(budget // 4 + 1, 1)
    with pytest.raises(ValueError):
        go.onehot_layout(0, 5)


def test_onehot_wrapper_raises_where_a_tile_cannot_fit():
    """The wrapper checks the tile before it loads the kernel, so the
    check holds without a card; the ops layer runs the plain version on
    CPU tensors and takes any K."""
    n = 64
    gid = torch.zeros(n, dtype=torch.int32)
    vals = torch.ones((n, 5), dtype=torch.float32)
    K = roofline.smem_budget_bytes() // (4 * 5) + 1
    with pytest.raises(ValueError, match="shared memory"):
        go.groupby_onehot_cuda(gid, vals, n_groups=K)
    with pytest.raises(ValueError):
        go.groupby_onehot_cuda(gid, vals, n_groups=0)


# -- block_sort.cuh's index arithmetic in numpy ------------------------------

def _ctas(n):
    """``block_sort_ctas``: a CTA per 1024 rows, at least one."""
    return max(1, n // CTA_ROWS)


def _block_pass(perm, ev, q, d, n):
    """``block_pass`` over the cluster: ``perm`` is the CTAs' slices end to
    end. Each warp ranks its chunk of its CTA's slice 32 rows a step
    against its running digit counts; a row goes to its digit's offset in
    the cluster (digits below, then its digit in the CTAs below, then in
    its CTA's warps below) plus its rank."""
    C = _ctas(n)
    rows = n // C
    steps = -(-rows // THREADS)
    chunk = steps * 32
    wc = np.zeros((C, WARPS, BINS + 1), np.int64)   # + the bin past a chunk
    src, keys, ranks = [], [], []
    lanes = np.arange(32)
    below = lanes[None, :] < lanes[:, None]
    for c in range(C):
        for w in range(WARPS):
            lo, hi = w * chunk, min(w * chunk + chunk, rows)
            for s in range(steps):
                i = lo + s * 32 + lanes
                ok = i < hi
                dig = np.full(32, BINS)
                pf = perm[c * rows + i[ok]]
                # a row's value from the CTA that owns the row
                dig[ok] = pf >> INV_BIT if q == 0 else \
                    (ev[pf & ROW_MASK] >> np.uint64(8 * d)) & np.uint64(0xFF)
                peers = dig[None, :] == dig[:, None]
                rank = wc[c, w, dig] + (peers & below).sum(1)
                np.add.at(wc[c, w], dig, 1)
                src.append(c * rows + i[ok])
                keys.append(np.stack([np.full(ok.sum(), c),
                                      np.full(ok.sum(), w), dig[ok]]))
                ranks.append(rank[ok])
    assert max((r.max() for r in ranks if r.size), default=0) < 1 << 9
    counts = wc[:, :, :BINS]
    warp_below = np.cumsum(counts, axis=1) - counts    # in the CTA
    cta = counts.sum(1)                                # [c, digit]
    cta_below = np.cumsum(cta, axis=0) - cta
    total = cta.sum(0)
    base = np.cumsum(total) - total                    # block_excl_sum
    src, ranks = np.concatenate(src), np.concatenate(ranks)
    c, w, dig = np.concatenate(keys, axis=1)
    dest = base[dig] + cta_below[c, dig] + warp_below[c, w, dig] + ranks
    assert np.array_equal(np.sort(dest), np.arange(n))
    out = perm.copy()
    out[dest] = perm[src]      # dest // rows: the CTA that owns it
    return out


def _block_sort(inv, keys, desc):
    """``block_sort``: lanes last to first, live digits only (the AND and
    OR over every CTA's slice), the flag last; returns the rows in sorted
    order."""
    n = len(inv)
    perm = np.arange(n) | (inv.astype(np.int64) << INV_BIT)
    for q in range(len(keys), 0, -1):
        ev = sortnet.encode_key(torch.from_numpy(keys[q - 1]),
                                desc[q - 1]).numpy().view(np.uint64)
        var = np.bitwise_and.reduce(ev) ^ np.bitwise_or.reduce(ev)
        for d in range(sortnet.RADIX_DIGITS):
            if (int(var) >> (8 * d)) & 0xFF:
                perm = _block_pass(perm, ev, q, d, n)
    if inv.min() != inv.max():
        perm = _block_pass(perm, None, 0, 0, n)
    return perm & ROW_MASK


@pytest.mark.parametrize("n", [1, 2, 33, 1024, 1 << 12, 1 << 14])
@pytest.mark.parametrize("desc", [[True, False], [False, True, False]])
def test_cluster_sort_model_is_lexsort_order(n, desc):
    """The kernel's ranks, offsets and scatter give ``lexsort_order``'s
    stable order, on 1, 4 and 16 CTAs: f64 keys with ties, -0.0, NaN and
    ±inf, int32 dates, int64 extremes, rows past the last warp's chunk."""
    rng = np.random.default_rng(n + len(desc))
    f = rng.normal(size=n).round(1) * 1e5
    f = np.where(rng.random(n) < 0.2, rng.choice(np.array(
        [-0.0, 0.0, np.nan, np.inf, -np.inf]), n), f)
    date = rng.integers(8000, 10_500, n).astype(np.int32)
    ext = rng.choice(np.array([np.iinfo(np.int64).min, -1, 0, 7,
                               np.iinfo(np.int64).max], np.int64), n)
    keys = [f, date, ext][:len(desc)]
    inv = (rng.random(n) < 0.3).astype(np.int32)
    want = sortnet.lexsort_order(
        [torch.from_numpy(inv)] + [torch.from_numpy(k) for k in keys],
        [1] + [-1 if d else 1 for d in desc])
    assert np.array_equal(_block_sort(inv, keys, desc), want.numpy())
