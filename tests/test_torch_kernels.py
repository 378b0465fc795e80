"""The port's scan-aggregate kernels against the reference's Pallas kernels.

The same seeded inputs go through ``repro.kernels.ops.fused_filter_agg`` /
``fused_groupby`` / ``fused_groupby_minmax`` (interpret mode, closures
from ``repro.exec.expr``) and through the port's plain versions, which
run the postfix programs compiled from the same expression dicts — so the
program compiler is held to the reference here too. Tolerance as the
reference's row parity tests: rtol = atol = 1e-9; counts and presence
exact. The CUDA kernels are held against the plain versions on the card
in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CoordinatorConfig, FaasPlatform, QueryCoordinator
from repro.exec import lower as ref_lower
from repro.kernels import ops as ref_ops
from repro.sql.physical import PlannerConfig
from repro.sql.queries import QUERIES
from repro_torch.analysis import roofline
from repro_torch.exec import lower as port_lower
from repro_torch.exec.operators import mixed_radix_strides
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import groupby_onehot as go
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import segmented_minmax as smm
from repro_torch.kernels.program import (MAX_STACK, ProgramError,
                                         compile_program, eval_slot)

TOL = dict(rtol=1e-9, atol=1e-9)
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
SQLS = {"q6": QUERIES["q6"], "q1": QUERIES["q1"], "minmax": MINMAX_SQL}
KERNEL = {"q6": "filter_agg", "q1": "groupby_onehot",
          "minmax": "segmented_minmax"}
CFG = CoordinatorConfig(planner=PlannerConfig(
    bytes_per_worker=250_000, broadcast_threshold_bytes=150_000,
    exchange_partitions=3), use_result_cache=False)


def _stage0_op(store, catalog, sql):
    coord = QueryCoordinator(store, catalog, platform=FaasPlatform(seed=1),
                             config=CFG)
    plan = coord.plan_sql(sql)
    return next(p.op for p in plan.pipelines.values() if p.scan_units)


@pytest.fixture(scope="module")
def matches(tpch_store):
    store, catalog = tpch_store
    return {q: ref_lower.match_fragment(_stage0_op(store, catalog, sql))
            for q, sql in SQLS.items()}


def _program(m):
    return compile_program(
        m.preds, [(fn, arg) for _, fn, arg in m.aggs],
        group_cols=list(m.group_cols),
        strides=mixed_radix_strides(list(m.sizes)),
        n_groups=int(np.prod(m.sizes)) if m.group_cols else 0)


def _reference(m, cols: dict, mask: np.ndarray) -> np.ndarray:
    """The Pallas kernel (interpret mode) with the reference's closures."""
    jcols = {c: jnp.asarray(v) for c, v in cols.items()}
    pred = ref_lower._compile_pred(m.preds)
    _, aggs = ref_lower._agg_closures(m.aggs)
    block = m.tiling.block_rows
    if m.kernel == "filter_agg":
        out = ref_ops.fused_filter_agg(jcols, jnp.asarray(mask), pred=pred,
                                       aggs=aggs, block=block)
    else:
        K = int(np.prod(m.sizes))
        gid = ref_lower._gid_fn(list(m.group_cols), list(m.sizes))
        f = (ref_ops.fused_groupby if m.kernel == "groupby_onehot"
             else ref_ops.fused_groupby_minmax)
        out = f(jcols, jnp.asarray(mask), pred=pred, gid_fn=gid, aggs=aggs,
                n_groups=K, block=block)
    return np.asarray(out)


def _port_plain(m, cols: dict, mask: np.ndarray) -> np.ndarray:
    tcols = {c: torch.from_numpy(v) for c, v in cols.items()}
    f = {"filter_agg": fa.fused_filter_agg_plain,
         "groupby_onehot": go.fused_groupby_plain,
         "segmented_minmax": smm.fused_groupby_minmax_plain}[m.kernel]
    return f(tcols, torch.from_numpy(mask), program=_program(m)).numpy()


def _assert_same(m, got, want):
    assert got.shape == want.shape
    assert got.dtype == np.float64
    counts = [j for j, (_, fn, _) in enumerate(m.aggs) if fn == "count"]
    if m.kernel != "filter_agg":
        counts.append(-1)                      # presence
    for j in counts:
        np.testing.assert_array_equal(got[..., j], want[..., j])
    np.testing.assert_allclose(got, want, **TOL)


def _block(tables, names, capacity, n=None):
    li = tables["lineitem"]
    n = min(capacity, len(li["l_orderkey"])) if n is None else n
    cols = {}
    for c in names:
        v = np.zeros(capacity, li[c].dtype)
        v[:n] = li[c][:n]
        cols[c] = v
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return cols, mask


def _names(m):
    return sorted(m.leaf["columns"])


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("query", ["q6", "q1", "minmax"])
def test_plain_matches_pallas_on_planned_programs(matches, tpch_tables,
                                                  query, capacity):
    m = matches[query]
    assert m is not None and m.kernel == KERNEL[query]
    cols, mask = _block(tpch_tables, _names(m), capacity)
    _assert_same(m, _port_plain(m, cols, mask), _reference(m, cols, mask))


@pytest.mark.parametrize("query", ["q6", "q1", "minmax"])
def test_all_masked_block_gives_identities(matches, tpch_tables, query):
    m = matches[query]
    cols, mask = _block(tpch_tables, _names(m), 1024)
    mask[:] = False
    got, want = _port_plain(m, cols, mask), _reference(m, cols, mask)
    _assert_same(m, got, want)
    ident = {"sum": 0.0, "count": 0.0, "min": np.inf, "max": -np.inf}
    expect = np.array([ident[fn] for _, fn, _ in m.aggs])
    if m.kernel == "filter_agg":
        np.testing.assert_array_equal(got, expect)
    else:
        np.testing.assert_array_equal(got[:, :-1],
                                      np.broadcast_to(expect, got[:, :-1].shape))
        assert not got[:, -1].any()


@pytest.mark.parametrize("query", ["q1", "minmax"])
def test_empty_groups_keep_identities(matches, tpch_tables, query):
    m = matches[query]
    cols, mask = _block(tpch_tables, _names(m), 1 << 16)
    mask &= cols["l_returnflag"] == 1            # the other flags: empty
    got, want = _port_plain(m, cols, mask), _reference(m, cols, mask)
    _assert_same(m, got, want)
    empty = got[:, -1] == 0
    assert empty.any() and not empty.all()


def _synthetic(K1, K2, n, capacity, seed):
    rng = np.random.default_rng(seed)
    cols = {"g1": rng.integers(0, K1, capacity).astype(np.int32),
            "g2": rng.integers(0, K2, capacity).astype(np.int64),
            "x": rng.normal(size=capacity),
            "y": rng.integers(-50, 50, capacity).astype(np.int64)}
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return cols, mask


def _synthetic_match(kernel, K1, K2, aggs, preds=()):
    return ref_lower.Match(kernel, {"t": "scan_table"}, list(preds),
                           ["g1", "g2"], [K1, K2], aggs,
                           ref_lower.roofline.groupby_tiling(
                               kernel, n_cols=4, n_aggs=len(aggs),
                               n_groups=K1 * K2))


X = {"t": "col", "name": "x"}
Y = {"t": "col", "name": "y"}


@pytest.mark.parametrize("kernel,aggs", [
    ("groupby_onehot", [["s", "sum", X], ["c", "count", None]]),
    ("segmented_minmax", [["lo", "min", X], ["hi", "max", Y]]),
])
def test_group_domain_up_to_the_port_cap(kernel, aggs):
    K = port_lower.MAX_KERNEL_GROUPS
    assert K == 4096 and roofline.group_tile_fits(K, len(aggs))
    m = _synthetic_match(kernel, 64, K // 64, aggs)
    cols, mask = _synthetic(64, K // 64, 1000, 1024, seed=3)
    got, want = _port_plain(m, cols, mask), _reference(m, cols, mask)
    _assert_same(m, got, want)
    assert (got[:, -1] == 0).any()               # most groups are empty


def test_group_ids_out_of_range_reach_no_group():
    aggs = [["s", "sum", X], ["c", "count", None], ["lo", "min", Y]]
    m = _synthetic_match("segmented_minmax", 3, 4, aggs)
    cols, mask = _synthetic(5, 4, 900, 1024, seed=4)    # g1 3, 4: no group
    got, want = _port_plain(m, cols, mask), _reference(m, cols, mask)
    _assert_same(m, got, want)
    assert got[:, -1].sum() == (mask & (cols["g1"] < 3)).sum()


def test_expression_kinds_match_pallas():
    """Case, in-list (literal and non-literal), not, or, / and literals
    mixed with integer columns, through the ungrouped kernel."""
    lit = lambda v: {"t": "lit", "value": v, "kind": "num"}  # noqa: E731
    case = {"t": "case", "cond": {"t": "cmp", "op": ">", "l": Y, "r": lit(0)},
            "then": {"t": "bin", "op": "/", "l": Y, "r": lit(4)},
            "else": {"t": "bin", "op": "*", "l": X, "r": lit(0.5)}}
    pred = {"t": "or", "terms": [
        {"t": "in", "term": {"t": "col", "name": "g1"},
         "values": [lit(1), lit(3)]},
        {"t": "not", "term": {"t": "in", "term": Y,
                              "values": [{"t": "col", "name": "g2"},
                                         lit(7)]}}]}
    aggs = [["a", "sum", case], ["b", "max", {"t": "bin", "op": "-", "l": Y,
                                              "r": lit(2.5)}],
            ["c", "count", None], ["d", "min", case]]
    m = ref_lower.Match("filter_agg", {"t": "scan_table"}, [pred], [], [],
                        aggs, ref_lower.roofline.filter_agg_tiling(
                            n_cols=4, n_aggs=4))
    cols, mask = _synthetic(5, 9, 1000, 1024, seed=5)
    _assert_same(m, _port_plain(m, cols, mask), _reference(m, cols, mask))


def test_program_compiler_refuses_what_the_kernel_cannot_run():
    s = {"t": "lit", "value": "x", "kind": "str"}
    with pytest.raises(ProgramError, match="not a number"):
        compile_program([{"t": "cmp", "op": "=", "l": X, "r": s}], [])
    deep = X
    for _ in range(MAX_STACK):
        deep = {"t": "bin", "op": "+", "l": X, "r": deep}
    with pytest.raises(ProgramError, match="stack"):
        compile_program([], [("sum", deep)])
    with pytest.raises(ProgramError, match="median"):
        compile_program([], [("median", X)])
    # the matcher turns a refusal into a miss reason, not a fallback
    op = {"t": "partial_agg", "strategy": "direct", "group_cols": [],
          "sizes": [], "aggs": [["s", "sum", X]],
          "child": {"t": "filter", "pred": {"t": "cmp", "op": "=", "l": X,
                                            "r": s},
                    "child": {"t": "scan_table", "columns": ["x"]}}}
    m, miss = port_lower.match_fragment_ex(op)
    assert m is None and "not a number" in miss


def test_program_slots_and_gid():
    p = compile_program([], [("count", None), ("sum", X)],
                        group_cols=["g1", "g2"], strides=[4, 1], n_groups=12)
    assert not p.has_pred and p.n_aggs == 2 and p.n_ops(2) == 0
    cols = {"g1": torch.tensor([0, 2, 1]), "g2": torch.tensor([3, 0, 1]),
            "x": torch.tensor([1.5, 2.0, 3.0], dtype=torch.float64)}
    assert eval_slot(p, 1, cols).tolist() == [3.0, 8.0, 5.0]
    assert eval_slot(p, 3, cols).tolist() == [1.5, 2.0, 3.0]


def test_ops_dispatch_runs_the_plain_version_on_cpu(matches, tpch_tables):
    m = matches["q6"]
    cols, mask = _block(tpch_tables, _names(m), 1024)
    tcols = {c: torch.from_numpy(v) for c, v in cols.items()}
    out = port_ops.fused_filter_agg(tcols, torch.from_numpy(mask),
                                    program=_program(m), tiling=None)
    np.testing.assert_allclose(out.numpy(), _reference(m, cols, mask), **TOL)
