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

from repro_torch.exec.expr import compile_expr, expr_from_dict
from repro_torch.kernels import bloom as bloomlib
from repro_torch.kernels.common import ACC_DTYPE, KEY_DTYPE, NEUTRAL
from repro_torch.kernels.sortnet import lexsort_order
from repro_torch.sql import ast

INT64_SENTINEL = np.iinfo(np.int64).max

Cols = dict[str, torch.Tensor]


# -- hashing (numpy and torch twins; must agree bit for bit) --------------------
#
# An exchange producer's destinations are computed on the card by the
# kernel of ``kernels/hash_partition.py`` (its plain version, on these
# torch twins, is its reference), on the host (``np_key_hash``) off the
# card or where the kernel cannot take the block, and by consumers that
# re-filter (``np_hash_dest``). Torch has no uint64 arithmetic, so the uint64 bits
# live in int64: XOR is the same, ``>>`` is masked to be logical, the
# products wrap mod 2^64 (the multipliers written as their two's-complement
# int64 values), and the unsigned remainder is taken on 32-bit halves.

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


def _signed64(m: int) -> int:
    return m - (1 << 64) if m >> 63 else m


_M1_I64 = _signed64(_M1)
_M2_I64 = _signed64(_M2)
_MASK32 = 0xFFFFFFFF


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the uint64 bits held in int64 ``x``."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """``hash64_np`` on a tensor: the uint64 hash's bits as int64."""
    x = x.to(torch.int64)
    x = (x ^ _shr(x, 30)) * _M1_I64
    x = (x ^ _shr(x, 27)) * _M2_I64
    return x ^ _shr(x, 31)


def combine_hash(cols: list[torch.Tensor]) -> torch.Tensor:
    h = hash64(cols[0])
    for c in cols[1:]:
        h = hash64(h ^ hash64(c))
    return h


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 bits of ``h`` modulo ``n`` (1 <= n <= 2^31), in int64:
    (hi · 2^32 + lo) mod n from the 32-bit halves, no product past 2^62."""
    if not 1 <= n <= 1 << 31:
        raise ValueError(f"n must lie in [1, 2^31], got {n}")
    hi, lo = _shr(h, 32), h & _MASK32
    return ((hi % n) * ((1 << 32) % n) + lo) % n


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


def _segment_keys(keys, seg, n: int):
    """``segment_min`` of int64 keys into n segments: empty segments keep
    INT64_SENTINEL (the int64 identity of min)."""
    out = torch.full((n,), INT64_SENTINEL, dtype=KEY_DTYPE,
                     device=keys.device)
    return out.scatter_reduce_(0, seg, keys, "amin", include_self=True)


def make_sort_agg(group_cols: list[str],
                  aggs: list[tuple[str, str, ast.Expr | None]]):
    """General grouped aggregation: lexicographic sort + segment reduce.

    Output capacity equals input capacity (#groups ≤ #rows); invalid rows
    sort last via a leading invalid flag and produce masked-out segments.
    Empty segments hold INT64_SENTINEL keys, 0 sums and counts, ±inf
    min/max and a false mask.
    """
    agg_fns = [(name, fn, compile_expr(arg) if arg is not None else None)
               for name, fn, arg in aggs]

    def op(cols: Cols, mask):
        n = int(mask.shape[0])
        inv = (~mask).to(torch.int32)
        keys = [cols[c].to(KEY_DTYPE) for c in group_cols]
        order = lexsort_order([inv] + keys)
        s_inv = inv[order]
        s_keys = [k[order] for k in keys]
        s_mask = mask[order]
        diff = s_inv[1:] != s_inv[:-1]
        for k in s_keys:
            diff = diff | (k[1:] != k[:-1])
        flags = torch.cat([torch.ones((1,), dtype=torch.bool,
                                      device=mask.device), diff])
        seg = torch.cumsum(flags, 0) - 1
        out: Cols = {}
        for c, k in zip(group_cols, s_keys):
            out[c] = _segment_keys(
                torch.where(s_mask, k, INT64_SENTINEL), seg, n)
        maskf = s_mask.to(ACC_DTYPE)
        for name, fn, argf in agg_fns:
            if fn == "count":
                v = maskf
            else:
                v = argf(cols)
                if not isinstance(v, torch.Tensor):
                    v = torch.tensor(v, device=mask.device)
                v = v.to(mask.device, ACC_DTYPE).expand(mask.shape)[order]
            if fn in ("sum", "count"):
                out[name] = _segment(v * maskf, seg, n, "sum")
            elif fn == "min":
                out[name] = _segment(torch.where(s_mask, v, float("inf")),
                                     seg, n, "min")
            elif fn == "max":
                out[name] = _segment(torch.where(s_mask, v, float("-inf")),
                                     seg, n, "max")
        present = torch.zeros((n,), dtype=torch.int64, device=mask.device)
        out_mask = present.index_add_(0, seg, s_mask.to(torch.int64)) > 0
        return out, out_mask
    return op


MERGE_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def merge_aggs_spec(aggs: list[tuple[str, str, ast.Expr | None]]):
    """Aggregation spec for merging partial states: re-aggregate the partial
    accumulator columns with the merge function (avg was already decomposed
    into sum/count by the binder)."""
    return [(name, MERGE_FN[fn], ast.Col(name)) for name, fn, _ in aggs]


# -- join -----------------------------------------------------------------------

def sort_build_side(build_cols: Cols, build_mask, build_key: str):
    """The build side's join keys sorted ascending, masked rows pushed to
    the end under INT64_SENTINEL, and the sorting permutation (stable:
    among equal keys the first build row comes first, as jnp.argsort)."""
    bk = torch.where(build_mask, build_cols[build_key].to(KEY_DTYPE),
                     INT64_SENTINEL)
    sk, order = torch.sort(bk, stable=True)
    return sk, order


def make_pk_join_probe(probe_key: str, build_key: str,
                       payload_cols: list[str]):
    """FK→PK equi-join: binary-search probe against the sorted build side.

    Build keys are unique (PK) so each probe row matches ≤ 1 build row.
    Output occupies the probe block; misses/invalid rows are masked out.
    """

    def op(probe_cols: Cols, probe_mask, build_cols: Cols, build_mask):
        sk, order = sort_build_side(build_cols, build_mask, build_key)
        pk = probe_cols[probe_key].to(KEY_DTYPE)
        pos = torch.searchsorted(sk, pk)
        pos_c = pos.clamp(0, sk.shape[0] - 1)
        hit = (sk[pos_c] == pk) & probe_mask & (pk != INT64_SENTINEL)
        sel = order[pos_c]
        out = dict(probe_cols)
        for c in payload_cols:
            if c not in out:
                out[c] = build_cols[c][sel]
        return out, hit
    return op


# -- the whole chain ------------------------------------------------------------

def build_chain(op: dict, leaves: list[tuple[str, dict]]):
    """A fragment's whole operator chain as one pure function over named
    leaf blocks (the generic program of ``exec.fragment``; the kernel
    arms of ``exec.lower`` run parts of it too). Each leaf appends
    ``(leaf id, op)`` to ``leaves``, in the order the tree is walked."""
    t = op["t"]
    if t in ("scan_table", "scan_exchange"):
        leaf_id = f"in{len(leaves)}"
        leaves.append((leaf_id, op))
        return lambda blocks: blocks[leaf_id]
    if t == "filter":
        child = build_chain(op["child"], leaves)
        f = make_filter(expr_from_dict(op["pred"]))

        def run_filter(blocks):
            cols, mask = child(blocks)
            return f(cols, mask)
        return run_filter
    if t == "project":
        child = build_chain(op["child"], leaves)
        f = make_project([(n, expr_from_dict(e))
                          for n, e in op["exprs"]])

        def run_project(blocks):
            cols, mask = child(blocks)
            return f(cols, mask)
        return run_project
    if t in ("partial_agg", "merge_agg"):
        child = build_chain(op["child"], leaves)
        aggs = [(n, fn, expr_from_dict(a) if a else None)
                for n, fn, a in op["aggs"]]
        if op["strategy"] == "direct":
            f, _ = make_direct_agg(op["group_cols"], op["sizes"], aggs)
        else:
            f = make_sort_agg(op["group_cols"], aggs)

        def run_agg(blocks):
            cols, mask = child(blocks)
            return f(cols, mask)
        return run_agg
    if t == "semijoin_probe":
        # generic arm of the fused Bloom probe (exec.lower's
        # ``bloom_filter`` arm): same hash family, same reserved
        # ``__bloom_pass`` column, bit for bit. The filter words arrive
        # through the runtime ``__bloom`` pseudo-leaf, so the cached
        # program never holds a query's filter contents.
        child = build_chain(op["child"], leaves)
        key, bits, k = op["key"], int(op["bits"]), int(op["k"])
        leaves.append(("__bloom", {"t": "bloom_words"}))

        def run_semijoin(blocks):
            cols, mask = child(blocks)
            words = blocks["__bloom"][0]["words"]
            hit = bloomlib.bloom_probe_plain(cols[key], words, bits,
                                             k) & mask
            out = dict(cols)
            out["__bloom_pass"] = hit.to(torch.int32)
            return out, mask
        return run_semijoin
    if t == "join":
        probe = build_chain(op["probe"], leaves)
        build = build_chain(op["build"], leaves)
        f = make_pk_join_probe(op["probe_key"], op["build_key"],
                               op["payload"])

        def run_join(blocks):
            pcols, pmask = probe(blocks)
            bcols, bmask = build(blocks)
            return f(pcols, pmask, bcols, bmask)
        return run_join
    raise TypeError(t)



# -- exchange partitioning -------------------------------------------------------

def make_hash_partitioner(key_cols: list[str], n_dest: int):
    """Appends a __dest column (hash of the key columns mod n_dest; -1 on
    masked rows)."""

    def op(cols: Cols, mask):
        h = combine_hash([cols[c] for c in key_cols])
        dest = umod(h, n_dest).to(torch.int32)
        out = dict(cols)
        out["__dest"] = torch.where(mask, dest, -1)
        return out, mask
    return op


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
