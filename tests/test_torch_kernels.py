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


# -- result types: the kernel programs follow the reference's float32 ----------

F = {"t": "col", "name": "f"}
D1, D2 = {"t": "col", "name": "d1"}, {"t": "col", "name": "d2"}
TYPED = {
    "int32_div_lit": {"t": "bin", "op": "/", "l": {"t": "bin", "op": "-",
                                                   "l": D1, "r": D2},
                      "r": {"t": "lit", "value": 7, "kind": "num"}},
    "int64_div_lit": {"t": "bin", "op": "/", "l": Y,
                      "r": {"t": "lit", "value": 7, "kind": "num"}},
    "int32_div_col": {"t": "bin", "op": "/", "l": D1, "r": D2},
    # (f + 1) * 0.3, not f * 0.3 + 1: XLA contracts a multiply-add into
    # one fused multiply-add, which the programs do not follow
    "f32_chain": {"t": "bin", "op": "*",
                  "l": {"t": "bin", "op": "+", "l": F,
                        "r": {"t": "lit", "value": 1, "kind": "num"}},
                  "r": {"t": "lit", "value": 0.3, "kind": "num"}},
    "case_f32": {"t": "case",
                 "cond": {"t": "cmp", "op": "<", "l": F,
                          "r": {"t": "lit", "value": 0.1, "kind": "num"}},
                 "then": {"t": "bin", "op": "/", "l": D1,
                          "r": {"t": "lit", "value": 3, "kind": "num"}},
                 "else": F},
}


@pytest.mark.parametrize("name", sorted(TYPED))
def test_program_types_follow_the_jitted_reference(name):
    """A typed program (``Program.specialise``) evaluates each expression
    to the value the reference's jitted jnp gives, bit for bit: float32
    where jnp computes in float32 (``int32 / 7``), and ``x / c`` as
    ``x * (1 / c)``, as XLA compiles it."""
    import jax
    from repro.exec.expr import compile_expr as ref_compile
    from repro.exec.expr import expr_from_dict as ref_from_dict
    from repro_torch.kernels.program import F32, for_columns
    rng = np.random.default_rng(13)
    n = 4096
    cols = {"d1": rng.integers(8000, 11000, n).astype(np.int32),
            "d2": rng.integers(1, 7000, n).astype(np.int32),
            "y": rng.integers(-50, 5000, n).astype(np.int64),
            "f": rng.normal(size=n).astype(np.float32)}
    ref = jax.jit(ref_compile(ref_from_dict(TYPED[name])))
    want = np.asarray(ref({c: jnp.asarray(v) for c, v in cols.items()}),
                      np.float64)
    prog = compile_program([], [("sum", TYPED[name])])
    tcols = {c: torch.from_numpy(v) for c, v in cols.items()}
    typed = for_columns(prog, tcols)
    got = eval_slot(typed, 2, tcols).numpy()
    np.testing.assert_array_equal(got, want)
    has_f32 = F32 in typed.code[:, 0].tolist()
    assert has_f32 == (name not in ("int64_div_lit",))
    assert for_columns(prog, tcols) is typed          # cached per dtypes


def test_kernel_division_follows_the_reference_result_type():
    """``(l_receiptdate - l_shipdate) / 7`` divides int32 dates: float32
    in the reference. The port's kernel path (the filter_agg kernel's
    plain version here) and its generic path equal ``repro`` at 1e-9;
    before the type pass the kernel path divided in f64 and missed by
    5e-8 relative."""
    import repro.api as ref_api
    import repro_torch.api as port_api
    sql = ("select sum((l_receiptdate - l_shipdate) / 7) as w "
           "from lineitem where l_quantity < 24")
    ref = ref_api.connect(tier="local", quota=4)
    port = port_api.connect(tier="local", quota=4, device="cpu")
    generic = port_api.connect(tier="local", quota=4, device="cpu")
    try:
        for s in (ref, port, generic):
            s.ensure_tpch(sf=0.01, n_parts=4)
        want = ref.sql(sql).fetch(ref.store)["w"]
        res = port.sql(sql)
        assert [p.kernel for p in res.stats.pipelines][0] == "filter_agg"
        np.testing.assert_allclose(res.fetch(port.store)["w"], want, **TOL)
        with port_lower.disabled():
            got = generic.sql(sql).fetch(generic.store)["w"]
        np.testing.assert_allclose(got, want, **TOL)
    finally:
        for s in (ref, port, generic):
            s.close()


@pytest.mark.parametrize("query", sorted(SQLS))
def test_scan_arms_carry_no_tiling(tpch_store, query):
    """The scan arms' kernels compile per program and size their grid
    from the compiled kernel's occupancy, so dispatch gives them no
    roofline tiling: none in EXPLAIN's kernel info, none in the program
    cache key."""
    op = _stage0_op(*tpch_store, SQLS[query])
    assert port_lower.kernel_info(op) == {"kernel": KERNEL[query],
                                          "miss": None, "tiling": None}
    assert port_lower.dispatch_signature(op)[:2] == (KERNEL[query], None)


def test_bloom_arm_carries_no_tiling():
    """The Bloom probe's kernel takes a chunk of rows a warp and sizes
    its grid from its own occupancy, so dispatch gives the
    ``bloom_filter`` arm no roofline tiling either: none in EXPLAIN's
    kernel info, none in the program cache key."""
    op = {"t": "semijoin_probe", "key": "l_orderkey", "bits": 1 << 21,
          "k": 6, "child": {"t": "scan_table", "table": "lineitem",
                            "columns": ["l_orderkey", "l_quantity"]}}
    assert port_lower.kernel_info(op) == {"kernel": "bloom_filter",
                                          "miss": None, "tiling": None}
    assert port_lower.dispatch_signature(op)[:2] == ("bloom_filter", None)


@pytest.mark.parametrize("make", [
    lambda: roofline.join_probe_tiling(n_cols=5, n_payload=1, n_aggs=2,
                                       n_groups=7),
    lambda: roofline.join_probe_tiling(n_cols=4, n_payload=2, n_aggs=2,
                                       n_groups=0),
], ids=["join_grouped", "join"])
def test_every_tiling_covers_whole_ctas_on_every_sm(make):
    """``resident_rows`` has one meaning for every kernel: the rows the
    whole grid covers per grid-stride step, a whole number of CTAs on
    each of the H100's SMs."""
    t = make()
    assert t.resident_rows == t.ctas * t.block_rows
    assert t.ctas % roofline.H100_SXM["sm_count"] == 0
    assert t.ctas >= roofline.H100_SXM["sm_count"]
