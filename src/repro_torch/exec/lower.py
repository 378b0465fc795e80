"""Kernel dispatch: lower matched fragment op trees to fused CUDA kernels.

Every fragment can run as the generic torch operator chain
(``repro_torch.exec.fragment``). This module is the dispatch layer on
top: a pattern matcher over the serialized fragment op tree recognizes
supported hot-loop chains and emits a kernel-backed program with the
same ``blocks → (columns, mask)`` signature, so the caller swaps it in;
every unmatched shape stays on the generic chain, and EXPLAIN shows why.

The matcher is the reference's (``repro.exec.lower``), with its miss
reasons verbatim. The port runs these arms (paper section 3.3's
one-pass vectorized worker loop):

  ``scan → [filter…] → partial_agg/merge_agg`` (direct, no groups)
      → :func:`repro_torch.kernels.ops.fused_filter_agg` (TPC-H Q6).

  ``scan → [filter…] → partial_agg/merge_agg`` (direct, K groups)
      → :func:`repro_torch.kernels.ops.fused_groupby` when every
        aggregate is a sum/count (TPC-H Q1), else
        :func:`~repro_torch.kernels.ops.fused_groupby_minmax`.

  ``join(probe=[filter…]→scan, build=[filter…]→scan) → [filter…] →
  partial_agg`` (direct)
      → :func:`repro_torch.kernels.ops.fused_join_probe_agg`: the build
        side sorted by key in a torch prepass, then one kernel filters
        on the probe side's own predicates, probes the survivors,
        gathers the payload, filters and aggregates (TPC-H Q12/Q14/Q19).

  ``semijoin_probe`` over ``[filter…]→scan`` (a probe-side scan carrying
  a u32 Bloom filter)
      → :func:`repro_torch.kernels.ops.fused_bloom_filter`, after the
        scan's predicate on the generic torch ops, as the reference does.

  ``scan → [filter…] → partial_agg/merge_agg`` (strategy ``sort``: group
  keys that are not dictionary coded), and the port alone: the same
  aggregate over a chain of ``join``, ``filter`` and ``project`` over
  scans (TPC-H Q3's join stage)
      → :func:`repro_torch.kernels.ops.fused_sort_agg`: the radix
        sort on ``[invalid] + keys``, a segmented scan and the
        compaction, after the chain (``operators.build_chain``), the
        predicate and the aggregate arguments on the generic torch ops,
        as the reference evaluates them.

  ``final`` with ORDER BY + LIMIT over ``[filter…]→scan`` (TPC-H Q3's)
      → :func:`repro_torch.kernels.ops.fused_topk`: the radix sort
        with per-key directions, then a gather of every column; the
        coordinator's host sort still runs on the survivors.

A kernel cannot call a Python closure, so the predicate, the aggregate
arguments and the group id compile to one postfix program
(:mod:`repro_torch.kernels.program`): the join kernel interprets it per
row, and the scan arms compile it into a kernel of its own at first use
(:mod:`repro_torch.kernels.specialise`). An expression the program
cannot hold (a non-numeric literal, too many columns) is a miss reason
too.

Launch shapes are not hand constants: every arm but the scan arms asks
``repro_torch.analysis.roofline`` for a :class:`KernelTiling` derived
from the card's shared-memory and thread budgets. The tiling key joins
the program cache key (``dispatch_signature``) and its estimates surface
in EXPLAIN via :func:`kernel_info`. The scan arms (``filter_agg``,
``groupby_onehot``, ``segmented_minmax``) carry no tiling: their
kernels are compiled per program and size their grid from the compiled
kernel's occupancy (``kernels.specialise``); the matcher only checks
that a grouped tile fits one block's shared memory. Nor does the
``bloom_filter`` arm: its kernel sizes its grid from its own occupancy
(``csrc/bloom.cu``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import roofline
from repro_torch.exec import operators as xops
from repro_torch.exec.expr import compile_expr, expr_from_dict
from repro_torch.exec.operators import decode_group_ids, mixed_radix_strides
from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import ACC_DTYPE, KEY_DTYPE
from repro_torch.kernels.program import Program, ProgramError, \
    compile_program

# The grouped kernels keep a (K, A+1) f64 tile in one block's shared
# memory; the cap is the largest K whose tile fits at A = 4 (4096, as
# the reference's VMEM-derived cap). ``_match_agg`` also checks the
# query's own A.
MAX_KERNEL_GROUPS = roofline.onehot_group_capacity()
AGG_FNS = frozenset({"sum", "count", "min", "max"})
ONEHOT_AGG_FNS = frozenset({"sum", "count"})  # pure-sum groupby subset

_LEAF_OPS = ("scan_table", "scan_exchange")

_enabled = os.environ.get("SKYRISE_DISABLE_FUSED", "") not in ("1", "true")


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Toggle kernel dispatch globally; returns the previous setting."""
    global _enabled
    prev, _enabled = _enabled, bool(flag)
    return prev


@contextlib.contextmanager
def disabled():
    """Run a scope on the generic torch path (parity tests, benchmarks)."""
    prev = set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


@dataclasses.dataclass
class Match:
    kernel: str                  # kernel name (see module docstring)
    leaf: dict                   # probe-side scan op feeding the chain
    #                              (sort_agg: the chain under the filters)
    preds: list[dict]            # post-join/agg-level predicate dicts
    group_cols: list[str]
    sizes: list[int]
    aggs: list                   # [name, fn, arg expr dict | None]
    tiling: roofline.KernelTiling | None    # None: scan and Bloom arms
    # join_probe_agg only:
    build_leaf: dict | None = None
    probe_preds: list = dataclasses.field(default_factory=list)
    build_preds: list = dataclasses.field(default_factory=list)
    probe_key: str | None = None
    build_key: str | None = None
    payload: list = dataclasses.field(default_factory=list)
    # topk only:
    sort_keys: list = dataclasses.field(default_factory=list)
    limit: int | None = None
    # bloom_filter only (probe_key doubles as the bloom key column):
    bloom_bits: int | None = None
    bloom_k: int | None = None
    # the scan-aggregate arms: the kernel's expression program
    program: Program | None = None


@dataclasses.dataclass
class Lowered:
    fn: Callable                 # blocks → (columns, mask)
    leaves: list[tuple[str, dict]]
    kernel: str
    tiling: roofline.KernelTiling | None = None


def _expr_cols(d: dict, out: set) -> None:
    if d.get("t") == "col":
        out.add(d["name"])
    for v in d.values():
        if isinstance(v, dict):
            _expr_cols(v, out)
        elif isinstance(v, list):
            for x in v:
                if isinstance(x, dict):
                    _expr_cols(x, out)


def _peel_filters(op: dict) -> tuple[list[dict], dict]:
    preds: list[dict] = []
    while op.get("t") == "filter":
        preds.append(op["pred"])
        op = op["child"]
    return preds, op


def _leaf_width(leaf: dict, fallback: int) -> int:
    """Column count feeding a kernel: exact for table scans, an estimate
    for exchange scans whose schema is only known at runtime."""
    if leaf.get("t") == "scan_table":
        return len(leaf["columns"])
    return max(fallback, 1)


def match_fragment_ex(op: dict) -> tuple[Match | None, str | None]:
    """Recognize a fragment op tree one of the fused kernels covers.

    Returns ``(match, None)`` on success or ``(None, miss_reason)`` — a
    short human-readable account of the first structural property that
    disqualified the tree, surfaced in EXPLAIN ANALYZE so erosion of
    match coverage is observable.
    """
    t = op.get("t")
    if t == "final":
        return _match_final(op)
    if t in ("partial_agg", "merge_agg"):
        return _match_agg(op)
    if t == "semijoin_probe":
        return _match_semijoin(op)
    return None, f"no fusible root (op={t})"


def _match_final(op: dict):
    sort_keys = [(k, bool(d)) for k, d in (op.get("sort_keys") or [])]
    limit = op.get("limit")
    if not sort_keys or limit is None:
        return None, "final lacks ORDER BY + LIMIT (no top-k)"
    if op.get("project"):
        return None, "final has a post-project"
    preds, child = _peel_filters(op["child"])
    if child.get("t") not in _LEAF_OPS:
        return None, f"unsupported op under final (op={child.get('t')})"
    needed: set[str] = {k for k, _ in sort_keys}
    for p in preds:
        _expr_cols(p, needed)
    if child["t"] == "scan_table" and not needed <= set(child["columns"]):
        missing = sorted(needed - set(child["columns"]))
        return None, f"columns {missing} absent from scan"
    if len(sort_keys) >= roofline.SORT_MAX_LANES:
        return None, (f"{len(sort_keys)} sort keys exceed the kernel's "
                      f"{roofline.SORT_MAX_LANES - 1}")
    return Match("topk", child, preds, [], [], [],
                 roofline.sort_tiling("topk", n_keys=len(sort_keys)),
                 sort_keys=sort_keys, limit=int(limit)), None


def _match_semijoin(op: dict):
    """``semijoin_probe`` wrapper (attached by the fragment executor when a
    probe-side spec carries a kernel-eligible Bloom filter): the scan
    chain's predicate, then the in-kernel Bloom membership test. The
    filter words arrive as the runtime ``__bloom`` pseudo-leaf, so one
    program serves every filter of the same shape."""
    key = op["key"]
    preds, child = _peel_filters(op["child"])
    if child.get("t") not in _LEAF_OPS:
        return None, (f"semijoin probe over non-scan chain "
                      f"(op={child.get('t')})")
    needed: set[str] = {key}
    for p in preds:
        _expr_cols(p, needed)
    if child["t"] == "scan_table" and not needed <= set(child["columns"]):
        missing = sorted(needed - set(child["columns"]))
        return None, f"columns {missing} absent from scan"
    return Match("bloom_filter", child, preds, [], [], [], None,
                 probe_key=key, bloom_bits=int(op["bits"]),
                 bloom_k=int(op["k"])), None


def bloom_probe_chain(op: dict) -> bool:
    """Whether a probe-side op tree is the scan → [filter…] chain the
    ``bloom_filter`` arm takes (the fragment executor wraps no other)."""
    return _peel_filters(op)[1].get("t") in _LEAF_OPS


_CHAIN_OPS = ("join", "filter", "project")


def _chain_ok(op: dict) -> bool:
    """Whether the ``sort_agg`` arm runs the ops under a sort-strategy
    aggregate: a chain of joins, filters and projects over scans, which
    it runs on the generic torch ops."""
    t = op.get("t")
    if t in _LEAF_OPS:
        return True
    return t in _CHAIN_OPS and all(
        _chain_ok(op[k]) for k in ("child", "probe", "build") if k in op)


def _match_agg(op: dict):
    strategy = op.get("strategy")
    group_cols = list(op["group_cols"])
    sizes = list(op["sizes"] or [])
    aggs = list(op["aggs"])
    fns = {fn for _, fn, _ in aggs}
    if not fns <= AGG_FNS:
        return None, f"aggregate fns {sorted(fns - AGG_FNS)} unsupported"
    needed: set[str] = set(group_cols)
    for _, _, arg in aggs:
        if arg is not None:
            _expr_cols(arg, needed)
    preds, child = _peel_filters(op["child"])
    for p in preds:
        _expr_cols(p, needed)

    if strategy == "sort":
        if not _chain_ok(child):
            return None, (f"sort-strategy aggregate over non-scan child "
                          f"(op={child.get('t')})")
        if child["t"] == "scan_table" and \
                not needed <= set(child["columns"]):
            missing = sorted(needed - set(child["columns"]))
            return None, f"columns {missing} absent from scan"
        if len(group_cols) >= roofline.SORT_MAX_LANES \
                or len(aggs) > roofline.SORT_MAX_AGGS:
            return None, (f"{len(group_cols)} keys and {len(aggs)} "
                          f"aggregates exceed the kernel's "
                          f"{roofline.SORT_MAX_LANES - 1} and "
                          f"{roofline.SORT_MAX_AGGS}")
        return Match("sort_agg", child, preds, group_cols, sizes, aggs,
                     roofline.sort_tiling("sort_agg",
                                          n_keys=len(group_cols))), None
    if strategy != "direct":
        return None, f"aggregation strategy {strategy!r} unsupported"

    if group_cols:
        if len(sizes) != len(group_cols):
            return None, "group columns not dict-coded (no sizes)"
        K = int(np.prod(sizes))
        if K > MAX_KERNEL_GROUPS:
            return None, (f"group domain {K} exceeds the one-hot VMEM cap "
                          f"{MAX_KERNEL_GROUPS}")
        if not roofline.group_tile_fits(K, len(aggs)):
            return None, (f"group tile {K}x{len(aggs) + 1} f64 exceeds "
                          f"shared memory "
                          f"({roofline.smem_budget_bytes()} B)")
    else:
        K = 0

    if child.get("t") == "join":
        return _match_join(op, child, preds, needed, group_cols, sizes,
                           aggs, K)
    if child.get("t") not in _LEAF_OPS:
        return None, f"unsupported child op {child.get('t')}"
    if child["t"] == "scan_table" and not needed <= set(child["columns"]):
        missing = sorted(needed - set(child["columns"]))
        return None, f"columns {missing} absent from scan"
    try:
        program = compile_program(
            preds, [(fn, arg) for _, fn, arg in aggs],
            group_cols=group_cols, strides=mixed_radix_strides(sizes),
            n_groups=K)
    except ProgramError as e:
        return None, f"expression not runnable in a kernel: {e}"
    if not group_cols:
        kernel = "filter_agg"
    else:
        kernel = ("groupby_onehot" if fns <= ONEHOT_AGG_FNS
                  else "segmented_minmax")
    return Match(kernel, child, preds, group_cols, sizes, aggs, None,
                 program=program), None


def _match_join(op, join, preds, needed, group_cols, sizes, aggs, K):
    probe_preds, probe_leaf = _peel_filters(join["probe"])
    if probe_leaf.get("t") not in _LEAF_OPS:
        return None, (f"join probe side is not a scan chain "
                      f"(op={probe_leaf.get('t')})")
    build_preds, build_leaf = _peel_filters(join["build"])
    if build_leaf.get("t") not in _LEAF_OPS:
        return None, (f"join build side is not a scan chain "
                      f"(op={build_leaf.get('t')})")
    payload = list(join["payload"])
    probe_key, build_key = join["probe_key"], join["build_key"]
    for p in probe_preds:
        _expr_cols(p, needed)
    needed.add(probe_key)
    if probe_leaf["t"] == "scan_table":
        avail = set(probe_leaf["columns"]) | set(payload)
        if not needed <= avail:
            missing = sorted(needed - avail)
            return None, f"columns {missing} absent from join inputs"
    if build_leaf["t"] == "scan_table":
        bneeded = {build_key} | set(payload)
        for p in build_preds:
            _expr_cols(p, bneeded)
        if not bneeded <= set(build_leaf["columns"]):
            missing = sorted(bneeded - set(build_leaf["columns"]))
            return None, f"columns {missing} absent from build scan"
    try:
        program = compile_program(
            preds, [(fn, arg) for _, fn, arg in aggs],
            group_cols=group_cols, strides=mixed_radix_strides(sizes),
            n_groups=K, probe_preds=probe_preds)
    except ProgramError as e:
        return None, f"expression not runnable in a kernel: {e}"
    tiling = roofline.join_probe_tiling(
        n_cols=_leaf_width(probe_leaf, len(needed)),
        n_payload=len(payload), n_aggs=len(aggs), n_groups=K)
    return Match("join_probe_agg", probe_leaf, preds, group_cols, sizes,
                 aggs, tiling, build_leaf=build_leaf,
                 probe_preds=probe_preds, build_preds=build_preds,
                 probe_key=probe_key, build_key=build_key,
                 payload=payload, program=program), None


def match_fragment(op: dict) -> Match | None:
    """Recognize a fragment op tree one of the fused kernels covers."""
    m, _ = match_fragment_ex(op)
    return m


def kernel_miss_reason(op: dict) -> str | None:
    """Why ``op`` stays on the generic torch path (None if it matched)."""
    _, miss = match_fragment_ex(op)
    return miss


def dispatch_signature(op: dict) -> tuple[str, tuple | None, dict]:
    """(kernel name or "", tiling cache key, effective op) for an op tree
    — matching only, no program construction, so the compiled-program
    cache can form its key cheaply. ``final`` ops whose top-k arm misses
    dispatch on their child (the coordinator's host sort still runs)."""
    m, _ = match_fragment_ex(op)
    if m is not None:
        return m.kernel, m.tiling.key if m.tiling else None, op
    if op.get("t") == "final":
        return dispatch_signature(op["child"])
    return "", None, op


def match_kernel(op: dict) -> str | None:
    """Name of the fused kernel ``op`` lowers to, or None (plan/explain)."""
    kernel, _, _ = dispatch_signature(op)
    return kernel or None


def kernel_info(op: dict) -> dict:
    """Dispatch summary for EXPLAIN: ``{"kernel", "miss", "tiling"}``.

    ``kernel`` is the fused kernel the pipeline will actually run with
    (for ``final`` ops, possibly on the child under the host sort) or
    None; ``miss`` is the miss reason for the op that executes; ``tiling``
    the roofline tiling estimates of the matched kernel (None for the
    scan and Bloom arms, whose kernels size their own grid).
    """
    m, miss = match_fragment_ex(op)
    if m is None and op.get("t") == "final":
        info = kernel_info(op["child"])
        if info["kernel"] is None:
            # neither arm matched: the final's own reason names the
            # blocker (the child's is just "no fusible root")
            info["miss"] = miss
        return info
    if m is None:
        return {"kernel": None, "miss": miss, "tiling": None}
    return {"kernel": m.kernel, "miss": None,
            "tiling": m.tiling.as_dict() if m.tiling else None}


def lower_fragment(op: dict) -> Lowered | None:
    """Build the kernel-backed program for a matched fragment op tree.

    The returned function consumes the same leaf blocks as the generic
    chain and produces outputs identical in names, shapes, dtypes, and
    mask semantics to the generic operators — callers need no
    special-casing beyond swapping the function.
    """
    m = match_fragment(op)
    if m is None:
        return None
    if m.kernel == "join_probe_agg":
        return _lower_join_probe(m)
    if m.kernel == "bloom_filter":
        return _lower_bloom_filter(m)
    if m.kernel == "sort_agg":
        return _lower_sort_agg(m)
    if m.kernel == "topk":
        return _lower_topk(m)
    return _lower_direct_agg(m)


def _compile_pred(preds: list[dict]):
    """The conjunction of ``preds`` on the generic torch ops (None if
    there is none)."""
    if not preds:
        return None
    fns = [compile_expr(expr_from_dict(p)) for p in preds]

    def pred(cols):
        out = fns[0](cols)
        for f in fns[1:]:
            out = out & f(cols)
        return out
    return pred


def _lower_direct_agg(m: Match) -> Lowered:
    agg_names = [name for name, _, _ in m.aggs]
    program = m.program
    leaf_id = "in0"
    leaves = [(leaf_id, m.leaf)]

    if m.kernel == "filter_agg":
        def fn(blocks):
            cols, mask = blocks[leaf_id]
            acc = kops.fused_filter_agg(cols, mask, program=program,
                                        tiling=None)
            out = {name: acc[j].reshape(1)
                   for j, name in enumerate(agg_names)}
            return out, torch.ones((1,), dtype=torch.bool,
                                   device=mask.device)
        return Lowered(fn, leaves, m.kernel, m.tiling)

    # grouped: mixed-radix group id over dict-coded key columns, same
    # code assignment as operators.make_direct_agg
    K = program.n_groups
    group_cols, sizes = list(m.group_cols), list(m.sizes)
    grouped = (kops.fused_groupby if m.kernel == "groupby_onehot"
               else kops.fused_groupby_minmax)

    def fn(blocks):
        cols, mask = blocks[leaf_id]
        tile = grouped(cols, mask, program=program, tiling=None)
        out = dict(decode_group_ids(group_cols, sizes, K, mask.device))
        for j, name in enumerate(agg_names):
            out[name] = tile[:, j]
        return out, tile[:, -1] > 0
    return Lowered(fn, leaves, m.kernel, m.tiling)


def _lower_join_probe(m: Match) -> Lowered:
    """Build side: its predicates on the generic ops, then the torch sort
    prepass (``operators.sort_build_side``, outside the kernel as the
    reference sorts in XLA). Probe side: one kernel call running the
    probe predicates (``probe_preds``, the program's probe-predicate
    slot) before its key search, then the residual predicates
    (``preds``), the group id and the aggregates over the hits and
    their payload. A build side past the kernel's cap
    (``roofline.JOIN_MAX_BUILD_ROWS``), or a probe batch of
    ``roofline.JOIN_MAX_PROBE_ROWS`` rows or more, takes the generic
    join and direct aggregation instead, as the reference's arm does
    past its cap."""
    build_pred = _compile_pred(m.build_preds)
    probe_pred = _compile_pred(m.probe_preds)
    agg_pred = _compile_pred(m.preds)
    program, tiling = m.program, m.tiling
    K = program.n_groups
    group_cols, sizes = list(m.group_cols), list(m.sizes)
    agg_names = [name for name, _, _ in m.aggs]
    probe_key, build_key = m.probe_key, m.build_key
    payload = [c for c in m.payload if c in program.names]
    leaves = [("in0", m.leaf), ("in1", m.build_leaf)]
    join_generic = xops.make_pk_join_probe(probe_key, build_key,
                                           list(m.payload))
    agg_generic, _ = xops.make_direct_agg(
        group_cols, sizes, [(n, fn, expr_from_dict(a) if a else None)
                            for n, fn, a in m.aggs])

    def fn(blocks):
        pcols, pmask = blocks["in0"]
        bcols, bmask = blocks["in1"]
        if build_pred is not None:
            bmask = bmask & build_pred(bcols)
        if int(bmask.shape[0]) > roofline.JOIN_MAX_BUILD_ROWS \
                or int(pmask.shape[0]) >= roofline.JOIN_MAX_PROBE_ROWS:
            pm = pmask if probe_pred is None else pmask & probe_pred(pcols)
            jcols, jmask = join_generic(pcols, pm, bcols, bmask)
            if agg_pred is not None:
                jmask = jmask & agg_pred(jcols)
            return agg_generic(jcols, jmask)
        sk, order = xops.sort_build_side(bcols, bmask, build_key)
        spay = {c: bcols[c][order] for c in payload if c not in pcols}
        res = kops.fused_join_probe_agg(pcols, pmask, sk, spay,
                                        probe_key=probe_key,
                                        program=program, tiling=tiling)
        if not K:
            out = {name: res[j].reshape(1)
                   for j, name in enumerate(agg_names)}
            return out, torch.ones((1,), dtype=torch.bool,
                                   device=pmask.device)
        out = dict(decode_group_ids(group_cols, sizes, K, pmask.device))
        for j, name in enumerate(agg_names):
            out[name] = res[:, j]
        return out, res[:, -1] > 0
    return Lowered(fn, leaves, m.kernel, m.tiling)


def _lower_bloom_filter(m: Match) -> Lowered:
    """Probe-side scan chain with the Bloom membership test in the
    kernel. The program keeps the generic mask semantics (predicate-
    surviving rows stay valid) and emits the verdict as the reserved
    ``__bloom_pass`` column, so the fragment executor counts killed rows
    exactly and compacts before partitioning; the generic arm
    (``operators.build_chain``'s ``semijoin_probe``) emits the same
    column."""
    pred = _compile_pred(m.preds)
    key, bits, k, tiling = m.probe_key, m.bloom_bits, m.bloom_k, m.tiling
    leaf_id = "in0"

    def fn(blocks):
        cols, mask = blocks[leaf_id]
        words = blocks["__bloom"][0]["words"]
        m2 = mask if pred is None else mask & pred(cols)
        hit = kops.fused_bloom_filter(cols[key], m2, words=words, bits=bits,
                                      k=k, tiling=tiling)
        out = dict(cols)
        out["__bloom_pass"] = hit.to(torch.int32)
        return out, m2
    return Lowered(fn, [(leaf_id, m.leaf),
                        ("__bloom", {"t": "bloom_words"})],
                   m.kernel, m.tiling)


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _lower_sort_agg(m: Match) -> Lowered:
    """The chain under the aggregate (its scan, or its joins, filters and
    projects: ``operators.build_chain``), the predicate, the int64 group
    keys and the f64 aggregate arguments on the generic torch ops (as the
    reference evaluates them outside its kernel), then one kernel call:
    sort, segmented scan, compaction. A capacity that is not a power of
    two, or one past the kernel's rows (the tiling's ``resident_rows``,
    ``SORT_MAX_ROWS``), takes the generic sort-aggregate instead, as the
    reference's arm does; the wrappers raise there."""
    pred = _compile_pred(m.preds)
    group_cols, tiling = list(m.group_cols), m.tiling
    names = [name for name, _, _ in m.aggs]
    fns = [fn for _, fn, _ in m.aggs]
    args = [compile_expr(expr_from_dict(arg)) if arg is not None else None
            for _, _, arg in m.aggs]
    generic = xops.make_sort_agg(
        group_cols, [(n, fn, expr_from_dict(a) if a else None)
                     for n, fn, a in m.aggs])
    cap = tiling.resident_rows
    leaves: list[tuple[str, dict]] = []
    child = xops.build_chain(m.leaf, leaves)

    def fn(blocks):
        cols, mask = child(blocks)
        m2 = mask if pred is None else mask & pred(cols)
        n = int(mask.shape[0])
        if not _is_pow2(n) or n > cap:
            return generic(cols, m2)
        keys = [cols[c].to(KEY_DTYPE) for c in group_cols]
        values = []
        for f, argf in zip(fns, args):
            if f == "count":
                values.append(None)
                continue
            v = argf(cols)
            if not isinstance(v, torch.Tensor):
                v = torch.tensor(v, device=mask.device)
            values.append(v.to(mask.device, ACC_DTYPE).expand(mask.shape))
        out_keys, out_vals, out_mask = kops.fused_sort_agg(
            keys, values, fns, m2, tiling=tiling)
        out = dict(zip(group_cols, out_keys))
        out.update(zip(names, out_vals))
        return out, out_mask
    return Lowered(fn, leaves, m.kernel, m.tiling)


def _lower_topk(m: Match) -> Lowered:
    """The predicate on the generic torch ops, then one kernel call: the
    batch sorted by the ORDER BY keys, the mask kept on the first
    ``limit`` valid rows. A capacity that is not a power of two, or one
    past the kernel's rows, passes the filtered batch through instead:
    the final stage's host sort and limit (``exec/fragment.py``) order
    it, as in the reference."""
    pred = _compile_pred(m.preds)
    sort_keys, limit, tiling = list(m.sort_keys), m.limit, m.tiling
    cap = tiling.resident_rows
    leaf_id = "in0"

    def fn(blocks):
        cols, mask = blocks[leaf_id]
        m2 = mask if pred is None else mask & pred(cols)
        n = int(mask.shape[0])
        if not _is_pow2(n) or n > cap:
            return cols, m2
        return kops.fused_topk(cols, m2, sort_keys=sort_keys, limit=limit,
                               tiling=tiling)
    return Lowered(fn, [(leaf_id, m.leaf)], m.kernel, m.tiling)
