"""Vectorized physical operator implementations (torch, fixed capacity).

Each factory takes plan-time parameters and returns a plain function over
(columns: dict[str, tensor], mask: bool tensor) pairs, so a fragment's
whole operator chain composes into one program over the fragment's
block. Data-dependent cardinalities are carried in the mask; outputs are
capacity-bounded.

Push-based vectorized execution per the paper (section 3.3): a "batch"
is the fragment's full block and operators push columns through
element-wise and segment computations. ``jax.ops.segment_*`` become
``index_add_`` / ``scatter_reduce_`` with explicit identities; ids that
fall outside [0, K) are dropped, as ``segment_sum`` drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.exec.expr import compile_expr
from repro_torch.kernels.common import ACC_DTYPE, KEY_DTYPE, NEUTRAL
from repro_torch.sql import ast

INT64_SENTINEL = np.iinfo(np.int64).max

Cols = dict[str, torch.Tensor]

_JOIN_SLICE = ("not ported yet: the generic join and sort arrive with the "
               "port's join slice (slice 2)")


# -- hashing (numpy; the device twin arrives with the join slice) ---------------

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


def hash64_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_M1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_M2)
    return x ^ (x >> np.uint64(31))


def combine_hash_np(cols: list[np.ndarray]) -> np.ndarray:
    h = hash64_np(cols[0])
    for c in cols[1:]:
        h = hash64_np(h ^ hash64_np(c))
    return h


# -- row-wise operators --------------------------------------------------------

def make_filter(pred: ast.Expr):
    fn = compile_expr(pred)

    def op(cols: Cols, mask):
        return cols, mask & fn(cols)
    return op


def make_project(exprs: list[tuple[str, ast.Expr]]):
    fns = [(name, compile_expr(e)) for name, e in exprs]

    def op(cols: Cols, mask):
        out = {}
        for name, f in fns:
            v = f(cols)
            if not isinstance(v, torch.Tensor):
                v = torch.tensor(v, device=mask.device)
            if v.shape != mask.shape:
                v = v.to(mask.device).expand(mask.shape)
            out[name] = v
        return out, mask
    return op


# -- aggregation ----------------------------------------------------------------

def mixed_radix_strides(sizes: list[int]) -> list[int]:
    """Strides assigning each group-key combination a unique id in
    [0, prod(sizes)) — shared by the direct aggregation and the fused
    grouped kernels so group codes agree bit-for-bit."""
    strides = []
    acc = 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    return list(reversed(strides))


def decode_group_ids(group_cols: list[str], sizes: list[int], K: int,
                     device: torch.device | str = "cpu") -> Cols:
    """Reconstruct the group-key columns from the mixed-radix ids."""
    ids = torch.arange(K, dtype=KEY_DTYPE, device=device)
    return {c: (ids // s) % size
            for c, s, size in zip(group_cols,
                                  mixed_radix_strides(sizes), sizes)}


def _segment(values, gid, K: int, reduce: str):
    """``jax.ops.segment_{sum,min,max}`` over ids in [0, K): rows whose
    id falls outside reach no segment; empty segments keep the
    identity (0, +inf, -inf)."""
    ok = (gid >= 0) & (gid < K)
    idx = torch.where(ok, gid, K).to(torch.int64)
    out = torch.full((K + 1,), NEUTRAL[reduce], dtype=values.dtype,
                     device=values.device)
    if reduce == "sum":
        out.index_add_(0, idx, values)
    else:
        out.scatter_reduce_(0, idx, values,
                            "amin" if reduce == "min" else "amax",
                            include_self=True)
    return out[:K]


def make_direct_agg(group_cols: list[str], sizes: list[int],
                    aggs: list[tuple[str, str, ast.Expr | None]]):
    """Group keys with a small known domain: group id = mixed-radix code.

    Output has exactly K = prod(sizes) rows (one per potential group),
    masked to groups with at least one input row.
    """
    K = int(np.prod(sizes)) if group_cols else 1
    strides = mixed_radix_strides(sizes)
    agg_fns = [(name, fn, compile_expr(arg) if arg is not None else None)
               for name, fn, arg in aggs]

    def op(cols: Cols, mask):
        # group ids in int32 arithmetic, as the reference computes them
        gid = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
        for c, s in zip(group_cols, strides):
            gid = gid + cols[c].to(torch.int32) * s
        gid = torch.where(mask, gid, 0)
        maskf = mask.to(ACC_DTYPE)
        out: Cols = dict(decode_group_ids(group_cols, sizes, K, mask.device))
        present = _segment(maskf, gid, K, "sum")
        for name, fn, argf in agg_fns:
            if fn == "count":
                out[name] = _segment(maskf, gid, K, "sum")
                continue
            v = argf(cols)
            if not isinstance(v, torch.Tensor):
                v = torch.tensor(v, device=mask.device)
            v = v.to(mask.device, ACC_DTYPE).expand(mask.shape)
            if fn == "sum":
                out[name] = _segment(v * maskf, gid, K, "sum")
            elif fn == "min":
                out[name] = _segment(torch.where(mask, v, float("inf")),
                                     gid, K, "min")
            elif fn == "max":
                out[name] = _segment(torch.where(mask, v, float("-inf")),
                                     gid, K, "max")
        if not group_cols:
            out_mask = torch.ones((1,), dtype=torch.bool, device=mask.device)
        else:
            out_mask = present > 0
        return out, out_mask
    return op, K


def make_sort_agg(group_cols: list[str],
                  aggs: list[tuple[str, str, ast.Expr | None]]):
    """General grouped aggregation (sort + segment reduce)."""
    raise NotImplementedError(f"make_sort_agg is {_JOIN_SLICE}")


MERGE_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def merge_aggs_spec(aggs: list[tuple[str, str, ast.Expr | None]]):
    """Aggregation spec for merging partial states: re-aggregate the partial
    accumulator columns with the merge function (avg was already decomposed
    into sum/count by the binder)."""
    return [(name, MERGE_FN[fn], ast.Col(name)) for name, fn, _ in aggs]


# -- join -----------------------------------------------------------------------

def make_pk_join_probe(probe_key: str, build_key: str,
                       payload_cols: list[str]):
    """FK→PK equi-join probe against the sorted build side."""
    raise NotImplementedError(f"make_pk_join_probe is {_JOIN_SLICE}")


# -- exchange partitioning -------------------------------------------------------

def np_key_hash(columns: dict[str, np.ndarray],
                key_cols: list[str]) -> np.ndarray:
    """Combined uint64 key hash — shared by destination routing and the
    per-partition distinct-key sketches workers emit for the adaptive
    re-optimizer."""
    return combine_hash_np([columns[c] for c in key_cols])


def np_hash_dest(columns: dict[str, np.ndarray], key_cols: list[str],
                 n_dest: int) -> np.ndarray:
    h = np_key_hash(columns, key_cols)
    return (h % np.uint64(n_dest)).astype(np.int32)


_NP_MERGE = {"sum": np.add, "min": np.minimum, "max": np.maximum}


def np_combine_partials(cols: dict[str, np.ndarray], group_cols: list[str],
                        aggs: list[tuple[str, str]]) -> dict[str, np.ndarray]:
    """Re-combine mergeable partial-aggregate states on the host.

    The multi-level exchange's merge wave collapses the partial states of
    its producer group before re-partitioning: rows sharing a group key
    are folded with the merge function of each aggregate column (sums
    add, counts were already decomposed to sums, min/max reduce). Order-
    independent up to float rounding, like the downstream merge_agg.
    """
    n = len(next(iter(cols.values()))) if cols else 0
    if n == 0:
        return cols
    if not group_cols:
        return {name: _NP_MERGE[fn].reduce(cols[name], keepdims=True)
                for name, fn in aggs}
    keys = [cols[c] for c in group_cols]
    order = np.lexsort(keys[::-1])
    skeys = [k[order] for k in keys]
    diff = np.zeros(n, bool)
    for k in skeys:
        diff[1:] |= k[1:] != k[:-1]
    diff[0] = True
    starts = np.flatnonzero(diff)
    out = {c: k[starts] for c, k in zip(group_cols, skeys)}
    for name, fn in aggs:
        out[name] = _NP_MERGE[fn].reduceat(cols[name][order], starts)
    return out


# -- distinct-key sketches (KMV) -------------------------------------------------

KMV_K = 32


def kmv_sketch(hashes: np.ndarray, k: int = KMV_K) -> list[int]:
    """K-minimum-values sketch of a uint64 hash column: the ``k``
    smallest *distinct* hash values. Tiny, mergeable, and order-free —
    workers attach one per output partition so the coordinator can
    estimate distinct join/group keys without a second pass."""
    if hashes.size == 0:
        return []
    u = np.unique(hashes)
    return [int(x) for x in u[:k]]


def kmv_merge(sketches: list[list[int]], k: int = KMV_K) -> list[int]:
    """Union of per-worker sketches (min-k of the combined value set)."""
    all_vals = [v for s in sketches for v in s]
    if not all_vals:
        return []
    u = np.unique(np.array(all_vals, dtype=np.uint64))
    return [int(x) for x in u[:k]]


def kmv_estimate(sketch: list[int], k: int = KMV_K) -> int:
    """Distinct-count estimate: exact below ``k`` values, else the
    classic (k-1) / kth-minimum fraction of the uint64 hash space."""
    if len(sketch) < k:
        return len(sketch)
    kth = max(sketch[k - 1], 1)
    return int((k - 1) * (2.0 ** 64) / kth)
