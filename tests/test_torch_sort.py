"""The port's sort path against the reference: the sorting network's and
segmented scan's plain twins, the sort-aggregate and top-k kernels' plain
versions, their dispatch arms, and end to end a non-dictionary GROUP BY
and TPC-H Q3.

Inputs are made with numpy from a seed and fed to both packages; the
reference's Pallas kernels run in interpret mode, as its own CPU tests
run them. Keys, masks, integer columns and top-k's columns must match
exactly; sums within rtol = atol = 1e-9 (the reference's row parity
tolerance: the port's plain scan takes the same steps, the reference's
kernel may round its adds in another order). Queries run at SF 0.01 on
the port's CPU path (``device="cpu"``: the kernels' plain versions)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import CoordinatorConfig as RefCoordinatorConfig
from repro.exec import lower as ref_lower
from repro.exec.batch import from_numpy as ref_from_numpy
from repro.exec.expr import compile_expr as ref_compile
from repro.exec.expr import expr_from_dict as ref_from_dict
from repro.kernels import sortnet as ref_sortnet
from repro.kernels.sort_agg import fused_sort_agg as ref_sort_agg
from repro.kernels.topk import fused_topk as ref_topk
from repro.sql.physical import PlannerConfig as RefPlannerConfig
import repro_torch.api as port_api
from repro_torch.analysis import roofline
from repro_torch.core import CoordinatorConfig
from repro_torch.exec import lower as port_lower
from repro_torch.exec import operators as port_ops
from repro_torch.exec.batch import bucket_capacity
from repro_torch.exec.batch import from_numpy as port_from_numpy
from repro_torch.exec.expr import compile_expr as port_compile
from repro_torch.exec.expr import expr_from_dict as port_from_dict
from repro_torch.kernels import ops, sortnet
from repro_torch.kernels import sort_agg as sa
from repro_torch.kernels import topk as tk
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler

TOL = dict(rtol=1e-9, atol=1e-9)
SENTINEL = np.iinfo(np.int64).max
# the reference's own sort-aggregate coverage query (BENCH_pr9.json's
# "sortagg" row): a GROUP BY over a key that is not dictionary coded
SORTAGG_SQL = ("select l_orderkey, sum(l_quantity) as s, count(*) as c "
               "from lineitem group by l_orderkey order by l_orderkey")
# the benchmark suites' planner (benchmarks/suites.py): Q3's final is a
# pipeline of its own even at SF 0.01
BENCH_PLANNER = dict(bytes_per_worker=500_000,
                     broadcast_threshold_bytes=250_000,
                     exchange_partitions=4)


def col(n):
    return {"t": "col", "name": n}


def lit(v):
    return {"t": "lit", "value": v, "kind": "num"}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- sortnet's plain twins ----------------------------------------------------------

def _sort_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 3, n).astype(np.int32),             # ties
            rng.integers(-2, 2, n).astype(np.int64),            # ties
            rng.normal(size=n).round(1),                         # ties, ±0
            rng.normal(size=n)]                                  # carried


@pytest.mark.parametrize("n", [1, 2, 1024])
@pytest.mark.parametrize("directions", [[1, 1, 1], [1, -1, 1], [-1, 1, -1]])
def test_lexsort_order_is_the_bitonic_network(n, directions):
    arrays = _sort_inputs(n, seed=n)
    arrays[2][::5] = -0.0
    want = ref_sortnet.bitonic_sort([jnp.asarray(a) for a in arrays],
                                    num_keys=3, directions=directions)
    order = sortnet.lexsort_order(
        [torch.from_numpy(a) for a in arrays[:3]], directions)
    for a, w in zip(arrays, want):
        np.testing.assert_array_equal(a[order.numpy()], np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 1024])
@pytest.mark.parametrize("fn", ["sum", "min", "max"])
def test_segmented_scan_matches_the_reference(n, fn):
    rng = np.random.default_rng(n + len(fn))
    vals = rng.normal(size=n)
    heads = rng.random(n) < 0.1
    ref_fn, port_fn, ident = {
        "sum": (jnp.add, torch.add, 0.0),
        "min": (jnp.minimum, torch.minimum, np.inf),
        "max": (jnp.maximum, torch.maximum, -np.inf)}[fn]
    want = ref_sortnet.segmented_scan(jnp.asarray(vals), jnp.asarray(heads),
                                      ref_fn, ident)
    got = sortnet.segmented_scan(torch.from_numpy(vals),
                                 torch.from_numpy(heads), port_fn, ident)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lexsort_descending_keeps_the_int64_minimum_and_nan_order():
    """Descending by ``torch.sort(descending=True)``, not negation: the
    int64 minimum stays last; NaN sorts above +inf (first when
    descending), as the CUDA key encoding puts it."""
    k = torch.tensor([0, np.iinfo(np.int64).min, 5, -1], dtype=torch.int64)
    assert sortnet.lexsort_order([k], [-1]).tolist() == [2, 0, 3, 1]
    f = torch.tensor([1.0, float("nan"), float("inf"), -0.0, 0.0])
    assert sortnet.lexsort_order([f]).tolist() == [3, 4, 0, 2, 1]
    assert sortnet.lexsort_order([f], [-1]).tolist() == [1, 2, 0, 3, 4]


def _lsd_radix_order(lanes: list) -> torch.Tensor:
    """``csrc/sortnet.cuh``'s sort in torch integer ops: a stable counting
    pass per 8-bit digit of the int64-held u64 lanes, the last lane's
    lowest digit first, from the identity permutation; a digit equal in
    every row is skipped, and a lane's first pass gathers it at the
    carried positions."""
    n = lanes[0].shape[0]
    order = torch.arange(n)
    for q, d in sortnet.live_digits(lanes):
        dig = (lanes[q][order] >> (8 * d)) & 0xFF
        onehot = torch.nn.functional.one_hot(dig, 256)
        rank = onehot.cumsum(0).gather(1, dig[:, None])[:, 0] - 1
        start = torch.cumsum(onehot.sum(0), 0) - onehot.sum(0)
        dest = start[dig] + rank
        new = torch.empty_like(order)
        new[dest] = order
        order = new
    return order


_EDGE_F64 = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1e-300, -1e-300,
                      np.finfo(np.float64).max, -np.finfo(np.float64).max])
_EDGE_I64 = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0,
                      -1, 1], np.int64)


@pytest.mark.parametrize("n", [1, 2, 700, 2048])
@pytest.mark.parametrize("directions", [[1, 1, 1], [1, -1, 1], [-1, -1, 1]])
def test_lsd_radix_order_is_lexsort_order(n, directions):
    """Stable LSD radix over the encoded lanes, invalid flag first, gives
    ``lexsort_order``'s total order (the bitonic network's, position
    last) on multi-lane keys with ties, -0.0, NaN, ±inf and the int64
    extremes."""
    rng = np.random.default_rng(n + 7)
    f = rng.normal(size=n).round(1)
    f = np.where(rng.random(n) < 0.3, rng.choice(_EDGE_F64, n), f)
    i = rng.integers(-3, 3, n).astype(np.int64)
    i = np.where(rng.random(n) < 0.2, rng.choice(_EDGE_I64, n), i)
    small = rng.integers(0, 4, n).astype(np.int32)
    inv = torch.from_numpy((rng.random(n) < 0.2).astype(np.int32))
    keys = [torch.from_numpy(a) for a in (f, i, small)]
    want = sortnet.lexsort_order([inv] + keys, [1] + directions)
    lanes = [inv.long()] + [sortnet.encode_key(k, descending=d < 0)
                            for k, d in zip(keys, directions)]
    assert torch.equal(_lsd_radix_order(lanes), want)


def test_lsd_radix_skips_constant_digits():
    """No live digit: the identity; keys below 2^23 with the flag: three
    key digits and the flag's one, the zero padding adding none (SF 1's
    GROUP BY l_orderkey)."""
    n = 64
    same = sortnet.encode_key(torch.full((n,), -5, dtype=torch.int64))
    assert sortnet.live_digits([torch.zeros(n, dtype=torch.int64),
                                same]) == []
    assert torch.equal(_lsd_radix_order([torch.zeros(n, dtype=torch.int64),
                                         same]), torch.arange(n))
    rng = np.random.default_rng(0)
    key = np.concatenate([rng.integers(1, 6_000_000, n - 8),
                          np.zeros(8, np.int64)])
    inv = torch.from_numpy(np.arange(n) >= n - 8).long()
    lanes = [inv, sortnet.encode_key(torch.from_numpy(key))]
    assert sortnet.live_digits(lanes) == [(1, 0), (1, 1), (1, 2), (0, 0)]
    assert torch.equal(_lsd_radix_order(lanes),
                       sortnet.lexsort_order([inv, torch.from_numpy(key)]))


def test_encode_key_orders_as_the_keys():
    """Unsigned order of the encoded bits is the keys' order: -0.0 ties
    +0.0, NaN above +inf, descending complemented."""
    f = torch.tensor([1.0, float("nan"), float("inf"), -0.0, 0.0,
                      -float("inf"), -2.5])
    u = sortnet.encode_key(f)
    as_unsigned = u ^ (-(1 << 63))      # signed order of these is unsigned
    assert torch.argsort(as_unsigned, stable=True).tolist() == \
        [5, 6, 3, 4, 0, 2, 1]
    assert int(u[3]) == int(u[4])
    assert torch.equal(sortnet.encode_key(f, descending=True), ~u)
    k = torch.tensor([np.iinfo(np.int64).min, -1, 0, np.iinfo(np.int64).max])
    ku = sortnet.encode_key(k) ^ (-(1 << 63))
    assert torch.equal(ku, k)


# -- the kernels' plain versions against the reference's kernels ----------------------

SA_AGGS = [("s", "sum", {"t": "bin", "op": "*", "l": col("x"),
                         "r": col("y")}),
           ("c", "count", None),
           ("lo", "min", col("x")),
           ("hi", "max", {"t": "bin", "op": "/", "l": col("i"),
                          "r": lit(3)})]
SA_PRED = {"t": "cmp", "op": "<", "l": col("y"), "r": lit(0.8)}


def _sa_block(case: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    cols = {"g": rng.integers(0, 40, n).astype(np.int64),
            "i": rng.integers(-3, 3, n).astype(np.int64),
            "x": rng.normal(size=n), "y": rng.random(n)}
    mask = rng.random(n) < 0.8
    if case == "nan":                      # NaN / inf in masked rows
        cols["x"][~mask & (rng.random(n) < 0.5)] = np.nan
        cols["x"][~mask & (rng.random(n) < 0.5)] = np.inf
    if case == "sentinel":                 # a valid row keyed INT64_MAX
        cols["g"][rng.random(n) < 0.05] = SENTINEL
    if case == "all-masked":
        mask[:] = False
    return cols, mask


def _assert_totals(got, got_mask, want, name):
    """Segment totals at 1e-9. A sum over a masked segment that holds a
    NaN or inf is NaN in the port (``v * maskf``, IEEE) and 0 in the
    reference's interpreted kernel: XLA's simplifier rewrites
    ``v * convert(mask)`` to a select when it compiles the kernel body.
    Such a lane's mask is false; its total is compared as 0."""
    odd = np.isnan(got) & ~got_mask
    np.testing.assert_allclose(np.where(odd, 0.0, got), want, err_msg=name,
                               **TOL)


def _port_values(cols, mask, aggs):
    vals = []
    for _, fn, arg in aggs:
        if fn == "count":
            vals.append(None)
            continue
        v = port_compile(port_from_dict(arg))(cols)
        vals.append(torch.as_tensor(v, dtype=torch.float64)
                    .expand(mask.shape).contiguous())
    return vals


@pytest.mark.parametrize("case,group_cols,pred", [
    ("plain", ["g"], False), ("pred", ["g"], True), ("nan", ["g"], True),
    ("sentinel", ["g"], False), ("all-masked", ["g"], False),
    ("two-keys", ["g", "i"], True)])
def test_sort_agg_plain_matches_pallas(case, group_cols, pred):
    n = 256
    cols, mask = _sa_block(case, n, seed=len(case))
    rc, rm = ref_from_numpy(cols, n).columns, jnp.asarray(mask)
    pc, pm = port_from_numpy(cols, n, "cpu").columns, torch.from_numpy(mask)
    preds = [SA_PRED] if pred else []
    want, wmask = ref_sort_agg(
        rc, rm, group_cols=group_cols,
        pred=ref_lower._compile_pred(preds),
        aggs=[(a, f, ref_compile(ref_from_dict(e)) if e else None)
              for a, f, e in SA_AGGS], interpret=True)
    if pred:
        pm = pm & port_compile(port_from_dict(SA_PRED))(pc)
    keys, values, gmask = sa.fused_sort_agg_plain(
        [pc[c] for c in group_cols], _port_values(pc, pm, SA_AGGS),
        [f for _, f, _ in SA_AGGS], pm)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    for c, k in zip(group_cols, keys):
        np.testing.assert_array_equal(k.numpy(), np.asarray(want[c]))
    for (name, _, _), v in zip(SA_AGGS, values):
        _assert_totals(v.numpy(), gmask.numpy(), np.asarray(want[name]),
                       name)
    if case == "all-masked":
        assert not gmask.any()
    else:
        assert int(gmask.sum()) > 1


def _tk_block(case: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    cols = {"rev": rng.normal(size=n).round(1),
            "d": rng.integers(0, 4, n).astype(np.int32),
            "k": rng.integers(0, 1 << 40, n).astype(np.int64),
            "p": rng.integers(0, 3, n).astype(np.int32)}
    cols["rev"][::6] = -0.0                # ties of -0.0 with +0.0
    mask = rng.random(n) < 0.9
    if case == "nan":                      # NaN in masked rows' columns
        cols["k"] = cols["k"].astype(np.float64)
        cols["k"][~mask] = np.nan
    if case == "all-masked":
        mask[:] = False
    return cols, mask


@pytest.mark.parametrize("case,limit,pred", [
    ("plain", 10, False), ("pred", 10, True), ("nan", 25, False),
    ("all-masked", 10, False), ("limit-past-valid", 600, True)])
def test_topk_plain_matches_pallas(case, limit, pred):
    n = 256 if case != "limit-past-valid" else 512
    cols, mask = _tk_block(case, n, seed=len(case))
    sort_keys = [("rev", True), ("d", False)]
    rc, rm = ref_from_numpy(cols, n).columns, jnp.asarray(mask)
    pc, pm = port_from_numpy(cols, n, "cpu").columns, torch.from_numpy(mask)
    tpred = {"t": "cmp", "op": ">", "l": col("p"), "r": lit(0)}
    want, wmask = ref_topk(
        rc, rm, pred=ref_lower._compile_pred([tpred] if pred else []),
        sort_keys=sort_keys, limit=limit, interpret=True)
    if pred:
        pm = pm & port_compile(port_from_dict(tpred))(pc)
    got, gmask = tk.fused_topk_plain(pc, pm, sort_keys=sort_keys,
                                     limit=limit)
    assert list(got) == list(want)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    for c in want:
        assert got[c].dtype == pc[c].dtype
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
    assert int(gmask.sum()) == min(limit, int(pm.sum()))


def test_plain_versions_refuse_what_the_kernel_cannot_take():
    mask = torch.ones(1000, dtype=torch.bool)
    with pytest.raises(ValueError, match="power-of-two"):
        sa.fused_sort_agg_plain([torch.zeros(1000, dtype=torch.int64)],
                                [None], ["count"], mask)
    with pytest.raises(ValueError, match="power-of-two"):
        tk.fused_topk_plain({"a": torch.zeros(1000)}, mask,
                            sort_keys=[("a", False)], limit=3)
    with pytest.raises(ValueError, match="int64"):
        sa.fused_sort_agg_plain([torch.zeros(1024, dtype=torch.int32)],
                                [None], ["count"],
                                torch.ones(1024, dtype=torch.bool))


# -- the dispatch arms ----------------------------------------------------------------

SCAN = {"t": "scan_table", "columns": ["g", "i", "x", "y"]}


def _sort_agg_op(group_cols, pred):
    child = SCAN if not pred else {"t": "filter", "pred": SA_PRED,
                                   "child": SCAN}
    return {"t": "partial_agg", "strategy": "sort", "group_cols": group_cols,
            "sizes": None, "aggs": [list(a) for a in SA_AGGS],
            "child": child}


def _both(cols, n, mask):
    cap = bucket_capacity(n)
    rb, pb = ref_from_numpy(cols, cap), port_from_numpy(cols, cap, "cpu")
    full = np.zeros(cap, bool)
    full[:n] = mask
    return ({"in0": (rb.columns, rb.mask & jnp.asarray(full))},
            {"in0": (pb.columns, pb.mask & torch.from_numpy(full))})


@pytest.mark.parametrize("group_cols,pred", [(["g"], True),
                                             (["i", "g"], False)])
def test_sort_agg_arm_matches_the_reference_arm(group_cols, pred):
    cols, mask = _sa_block("nan", 700, seed=7)
    op = _sort_agg_op(group_cols, pred)
    rblocks, pblocks = _both(cols, 700, mask)
    with ref_lower.interpret_gate_disabled():
        ref = ref_lower.lower_fragment(op)
    port = port_lower.lower_fragment(op)
    assert ref.kernel == port.kernel == "sort_agg"
    assert port.leaves == ref.leaves
    want, wmask = ref.fn(rblocks)
    got, gmask = port.fn(pblocks)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    for c in want:
        assert got[c].dtype == (torch.int64 if c in group_cols
                                else torch.float64)
        if c in group_cols:
            np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
        else:
            _assert_totals(got[c].numpy(), gmask.numpy(),
                           np.asarray(want[c]), c)
    # and lane for lane (NaN included) the generic torch sort-aggregate
    generic, generic_mask = port_ops.make_sort_agg(
        group_cols, [(a, f, port_from_dict(e) if e else None)
                     for a, f, e in SA_AGGS])(
        pblocks["in0"][0], pblocks["in0"][1] & (
            port_compile(port_from_dict(SA_PRED))(pblocks["in0"][0])
            if pred else True))
    assert torch.equal(gmask, generic_mask)
    for c in generic:
        np.testing.assert_allclose(got[c].numpy(), generic[c].numpy(),
                                   err_msg=c, **TOL)


# the sort_agg arm over joins, the port's alone: Q3's join stage in small.
# The probe side is filtered, joined to a build side with unique keys and
# two payload columns; a filter over the join, and with ``project`` a
# project and a filter under it; grouped by the probe key and the payload.
JOIN_AGGS = [["rev", "sum", {"t": "bin", "op": "*", "l": col("x"),
                             "r": {"t": "bin", "op": "-", "l": lit(1),
                                   "r": col("y")}}],
             ["c", "count", None], ["lo", "min", col("x")]]
D_PRED = {"t": "cmp", "op": "<", "l": col("d"), "r": lit(30)}


def _join_agg_op(project: bool):
    join = {"t": "join",
            "probe": {"t": "filter", "pred": SA_PRED,
                      "child": {"t": "scan_exchange", "source": 0}},
            "build": {"t": "scan_exchange", "source": 1},
            "probe_key": "g", "build_key": "bk", "payload": ["d", "sp"]}
    child = {"t": "filter", "pred": D_PRED, "child": join}
    if project:
        child = {"t": "filter", "pred": {"t": "cmp", "op": ">",
                                         "l": col("sp"), "r": lit(0)},
                 "child": {"t": "project",
                           "exprs": [[c, col(c)]
                                     for c in ("g", "d", "sp", "x", "y")],
                           "child": child}}
    return {"t": "partial_agg", "strategy": "sort",
            "group_cols": ["g", "d", "sp"], "sizes": None,
            "aggs": JOIN_AGGS, "child": child}


def _join_blocks(n_probe: int, cap: int, seed: int):
    rng = np.random.default_rng(seed)
    nb = 64
    probe = {"g": rng.integers(0, nb + 8, n_probe).astype(np.int64),
             "x": rng.random(n_probe) + 0.5, "y": rng.random(n_probe)}
    build = {"bk": rng.permutation(nb).astype(np.int64),
             "d": rng.integers(0, 40, nb).astype(np.int64),
             "sp": rng.integers(0, 3, nb).astype(np.int32)}
    pb, bb = port_from_numpy(probe, cap, "cpu"), \
        port_from_numpy(build, nb, "cpu")
    pmask = pb.mask & torch.from_numpy(np.r_[rng.random(n_probe) < 0.9,
                                             np.zeros(cap - n_probe, bool)])
    return {"in0": (pb.columns, pmask), "in1": (bb.columns, bb.mask)}


@pytest.mark.parametrize("project", [False, True], ids=["join", "project"])
def test_sort_agg_arm_over_joins_equals_the_generic_chain(project):
    """The arm runs the chain under the aggregate on the generic ops and
    the aggregate on the kernel's plain version: keys and mask bit for
    bit, the totals within 1e-12 of ``make_sort_agg``'s, lane for lane."""
    op = _join_agg_op(project)
    blocks = _join_blocks(1000, 1024, seed=11 + project)
    lowered = port_lower.lower_fragment(op)
    assert lowered.kernel == "sort_agg"
    leaves: list = []
    generic = port_ops.build_chain(op, leaves)
    assert lowered.leaves == leaves
    got, gmask = lowered.fn(blocks)
    want, wmask = generic(blocks)
    assert sorted(got) == sorted(want)
    assert torch.equal(gmask, wmask) and 1 < int(gmask.sum()) < 1024
    for c in ("g", "d", "sp"):
        assert got[c].dtype == torch.int64 and torch.equal(got[c], want[c])
    for name, _, _ in JOIN_AGGS:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-12, atol=0, err_msg=name)


def _q3_join_stage(session):
    from repro_torch.core.engine import QueryEngine
    plan = QueryEngine(session.store, session.catalog,
                       platform=session.platform,
                       handler=session.handler).plan_sql(QUERIES["q3"])
    (p,) = [p for p in plan.pipelines.values()
            if p.op["t"] == "partial_agg"]
    return p


def test_q3_join_stage_takes_the_sort_agg_arm_the_reference_misses(
        sessions):
    """Q3's stage 1 (scans → joins → partial aggregate) lowers to the
    port's sort_agg arm, where the reference's dispatch misses (its arm
    takes only a scan chain) and runs the generic ops."""
    _, port, _, _, _ = sessions
    p = _q3_join_stage(port)
    assert "join" in _op_kinds(p.op)
    info = port_lower.kernel_info(p.op)
    assert info["kernel"] == "sort_agg" and info["miss"] is None
    assert info["tiling"]["block_rows"]
    assert p.kernel == "sort_agg" and p.kernel_miss_reason is None
    with ref_lower.interpret_gate_disabled():
        assert ref_lower.kernel_info(p.op)["miss"] == \
            "sort-strategy aggregate over non-scan child (op=join)"


def _op_kinds(op):
    out = [op["t"]]
    for k in ("child", "probe", "build"):
        if k in op:
            out += _op_kinds(op[k])
    return out


_SCAN_A = {"t": "scan_table", "columns": ["a", "b"]}


@pytest.mark.parametrize("child,blocker", [
    ({"t": "semijoin_probe", "key": "a", "bits": 1024, "k": 6,
      "child": _SCAN_A}, "semijoin_probe"),
    ({"t": "join", "probe": _SCAN_A, "probe_key": "a", "build_key": "b",
      "payload": [], "build": {"t": "partial_agg", "strategy": "sort",
                               "group_cols": ["b"], "sizes": None,
                               "aggs": [["c", "count", None]],
                               "child": _SCAN_A}}, "join"),
    ({"t": "filter", "pred": {"t": "cmp", "op": ">", "l": col("a"),
                              "r": lit(0)},
      "child": {"t": "final", "sort_keys": [], "limit": None,
                "child": _SCAN_A}}, "final"),
], ids=["semijoin", "agg-build", "final"])
def test_sort_agg_arm_names_the_op_it_does_not_take(child, blocker):
    op = {"t": "partial_agg", "strategy": "sort", "group_cols": ["a"],
          "sizes": None, "aggs": [["c", "count", None]], "child": child}
    want = f"sort-strategy aggregate over non-scan child (op={blocker})"
    assert port_lower.kernel_info(op) == {"kernel": None, "miss": want,
                                          "tiling": None}
    assert port_lower.lower_fragment(op) is None


@pytest.mark.parametrize("mode", ["broadcast", "repartitioned", "disabled"])
def test_q3_join_stage_on_the_sort_agg_arm_equals_oracle_and_repro(
        sessions, mode):
    """Q3 at SF 0.01 with its joins broadcast (the default planner) and
    repartitioned (9 partitions, both sides hashed): the join stage runs
    sort_agg on every fragment, and the rows equal the oracle's and the
    reference's; under ``lower.disabled()`` every stage runs the generic
    chain, with the same rows."""
    _, port, catalog, _, tables = sessions
    planner = {} if mode != "repartitioned" else dict(
        broadcast_threshold_bytes=0, exchange_partitions=9,
        exchange_strategy="combining")
    s = port_api.connect(
        store=port.store, quota=8, device="cpu",
        config=CoordinatorConfig(planner=PlannerConfig(**planner),
                                 use_result_cache=False))
    # the reference on a store of its own, so that its runs share no
    # exchange or result objects with the other tests' runs
    r = ref_api.connect(
        tier="local", quota=8,
        config=RefCoordinatorConfig(planner=RefPlannerConfig(**planner),
                                    use_result_cache=False))
    try:
        s.ensure_tpch(sf=0.01, n_parts=4)
        r.ensure_tpch(sf=0.01, n_parts=4)
        if mode == "disabled":
            with port_lower.disabled():
                res = s.sql(QUERIES["q3"])
            assert not any(p.kernel for p in res.stats.pipelines)
        else:
            res = s.sql(QUERIES["q3"])
            # repartitioned, the final is a stage of its own, on topk
            assert [p.kernel for p in res.stats.pipelines if p.kernel] == \
                ["sort_agg"] + (["topk"] if planner else [])
            (stage,) = [p for p in res.stats.pipelines
                        if p.kernel == "sort_agg"]
            assert stage.kernel_fragments == stage.n_fragments >= 1
        got = res.fetch(s.store)
        assert len(got["revenue"]) == 10
        _assert_same_rows(got, _oracle(catalog, tables, QUERIES["q3"]),
                          f"q3 {mode} vs oracle")
        _assert_same_rows(got, r.sql(QUERIES["q3"]).fetch(r.store),
                          f"q3 {mode} vs repro")
    finally:
        s.close()
        r.close()


@pytest.mark.parametrize("pred", [False, True])
def test_topk_arm_matches_the_reference_arm(pred):
    cols, mask = _tk_block("plain", 700, seed=8)
    scan = {"t": "scan_exchange", "source": 0}
    child = scan if not pred else {
        "t": "filter", "pred": {"t": "cmp", "op": ">", "l": col("p"),
                                "r": lit(0)}, "child": scan}
    op = {"t": "final", "sort_keys": [["rev", True], ["d", False]],
          "limit": 10, "project": None, "child": child}
    rblocks, pblocks = _both(cols, 700, mask)
    with ref_lower.interpret_gate_disabled():
        ref = ref_lower.lower_fragment(op)
    port = port_lower.lower_fragment(op)
    assert ref.kernel == port.kernel == "topk"
    want, wmask = ref.fn(rblocks)
    got, gmask = port.fn(pblocks)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert int(gmask.sum()) == 10
    for c in want:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))


def test_sort_tiling_fits_two_tiles_per_sm():
    for kernel, n_keys in (("sort_agg", 1), ("topk", 2), ("topk", 15)):
        t = roofline.sort_tiling(kernel, n_keys=n_keys)
        assert t.block_rows & (t.block_rows - 1) == 0
        assert t.resident_rows == roofline.SORT_MAX_ROWS
        assert 2 * (t.smem_bytes + 1024) <= \
            roofline.H100_SXM["smem_per_sm"]
        assert t.dominant == "memory"
    assert roofline.sort_tiling("sort_agg", n_keys=1).block_rows == 1 << 12
    info = port_lower.kernel_info(_sort_agg_op(["g"], False))
    assert info["kernel"] == "sort_agg" and info["tiling"]["block_rows"]


def test_too_many_sort_keys_miss_with_a_reason():
    op = {"t": "final", "sort_keys": [[f"c{j}", False] for j in range(16)],
          "limit": 3, "project": None,
          "child": {"t": "scan_exchange", "source": 0}}
    assert "exceed the kernel's 15" in port_lower.kernel_miss_reason(op)


def test_ops_dispatch_runs_the_plain_versions_on_cpu():
    cols, mask = _sa_block("plain", 1024, seed=3)
    pc = port_from_numpy(cols, 1024, "cpu").columns
    pm = torch.from_numpy(mask)
    tiling = roofline.sort_tiling("sort_agg", n_keys=1)
    vals = _port_values(pc, pm, SA_AGGS)
    fns = [f for _, f, _ in SA_AGGS]
    got = ops.fused_sort_agg([pc["g"]], vals, fns, pm, tiling=tiling)
    want = sa.fused_sort_agg_plain([pc["g"]], vals, fns, pm)
    assert torch.equal(got[2], want[2]) and torch.equal(got[0][0],
                                                        want[0][0])
    out, om = ops.fused_topk(pc, pm, sort_keys=[("x", True)], limit=4,
                             tiling=roofline.sort_tiling("topk", n_keys=1))
    assert int(om.sum()) == 4 and torch.equal(out["x"][:4],
                                              pc["x"][pm].sort(
                                                  descending=True)
                                              .values[:4])


# -- end to end -----------------------------------------------------------------------

class _Recorder:
    def __init__(self, session):
        self.stats, self._lock, self._inner = [], threading.Lock(), \
            session.handler
        session.handler = self

    def __call__(self, payload):
        resp, runtime = self._inner(payload)
        with self._lock:
            self.stats.append(resp["stats"])
        return resp, runtime


@pytest.fixture(scope="module")
def sessions():
    ref = ref_api.connect(tier="local", quota=8)
    port = port_api.connect(tier="local", quota=8, device="cpu")
    ref.ensure_tpch(sf=0.01, n_parts=4)
    catalog = port.ensure_tpch(sf=0.01, n_parts=4)
    rec = _Recorder(port)
    ih = InputHandler(port.store)
    tables = {}
    for name in ("lineitem", "orders", "customer"):
        meta = catalog.tables[name]
        parts = [ih.read_table(f)[0] for f in meta.files]
        tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                        for c in meta.schema}
    yield ref, port, catalog, rec, tables
    ref.close()
    port.close()


def _assert_same_rows(got, want, ctx):
    keys = sorted(want)
    assert sorted(got) == keys, ctx
    arrs_g = [np.asarray(got[k], np.float64) for k in keys]
    arrs_w = [np.asarray(want[k], np.float64) for k in keys]
    og, ow = np.lexsort(arrs_g), np.lexsort(arrs_w)
    for k, g, w in zip(keys, arrs_g, arrs_w):
        np.testing.assert_allclose(g[og], w[ow], err_msg=f"{ctx} :: {k}",
                                   **TOL)


def _oracle(catalog, tables, sql):
    lqp, _ = Binder(catalog).bind(parse(sql))
    return oracle.run(optimize(lqp), tables)


def test_sortagg_query_runs_the_sort_agg_arm(sessions):
    ref, port, catalog, rec, tables = sessions
    rec.stats.clear()
    res = port.sql(SORTAGG_SQL)
    got = res.fetch(port.store)
    (stage0,) = [p for p in res.stats.pipelines if p.kernel]
    assert stage0.kernel == "sort_agg"
    assert stage0.kernel_fragments == stage0.n_fragments >= 1
    assert [s["kernel"] for s in rec.stats if s["kernel"]] == \
        ["sort_agg"] * stage0.n_fragments
    assert not any("not yet ported" in p.kernel_miss_reason
                   for p in res.stats.pipelines)
    assert got["l_orderkey"].tolist() == sorted(got["l_orderkey"].tolist())
    _assert_same_rows(got, _oracle(catalog, tables, SORTAGG_SQL),
                      "sortagg vs oracle")
    _assert_same_rows(got, ref.sql(SORTAGG_SQL).fetch(ref.store),
                      "sortagg vs repro")


def test_q3_final_runs_the_topk_arm_under_the_benchmark_planner(sessions):
    ref, port, catalog, rec, tables = sessions
    bench = port_api.connect(
        store=port.store, quota=8, device="cpu",
        config=CoordinatorConfig(planner=PlannerConfig(**BENCH_PLANNER)))
    rbench = ref_api.connect(
        store=ref.store, quota=8,
        config=RefCoordinatorConfig(planner=RefPlannerConfig(
            **BENCH_PLANNER)))
    try:
        bench.ensure_tpch(sf=0.01, n_parts=4)
        rbench.ensure_tpch(sf=0.01, n_parts=4)
        res = bench.sql(QUERIES["q3"])
        got = res.fetch(bench.store)
        # the join stage runs the port's own sort_agg arm over joins
        assert [p.kernel for p in res.stats.pipelines if p.kernel] == \
            ["sort_agg", "topk"]
        (final,) = [p for p in res.stats.pipelines if p.kernel == "topk"]
        assert final.kernel_fragments == final.n_fragments == 1
        assert not any("not yet ported" in p.kernel_miss_reason
                       for p in res.stats.pipelines)
        assert len(got["revenue"]) == 10
        assert list(got["revenue"]) == sorted(got["revenue"], reverse=True)
        _assert_same_rows(got, _oracle(catalog, tables, QUERIES["q3"]),
                          "q3 vs oracle")
        _assert_same_rows(got, rbench.sql(QUERIES["q3"]).fetch(ref.store),
                          "q3 vs repro")
    finally:
        bench.close()
        rbench.close()
