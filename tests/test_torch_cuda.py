"""The port on the card: each CUDA kernel against its plain version, and
the slices end to end on the default device (Q6, Q1, min/max; Q12, Q14,
Q19 and the selective semi-join; the GROUP BY l_orderkey and Q3 of the
sort path); and the four kernels no query reaches (the fixed-layout Q6
and grouped sums, flash attention, the SSD scan), each against its
plain version, with inputs its wrapper must refuse.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports neither ``jax`` nor ``repro``, so it runs on a machine
without JAX; there, skip the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.api import connect
from repro_torch.exec import lower
from repro_torch.analysis import roofline
from repro_torch.core import CoordinatorConfig
from repro_torch.kernels import bloom, ext, ops
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import join_probe as jp
from repro_torch.kernels import groupby_onehot as go
from repro_torch.kernels import segmented_minmax as smm
from repro_torch.kernels import sort_agg as sa
from repro_torch.kernels import topk as tk
from repro_torch.kernels.program import compile_program
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-9, atol=1e-9)
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
SQLS = {"q6": QUERIES["q6"], "q1": QUERIES["q1"], "minmax": MINMAX_SQL}
WRAPPERS = {"filter_agg": (ops.fused_filter_agg, fa.fused_filter_agg_plain),
            "groupby_onehot": (ops.fused_groupby, go.fused_groupby_plain),
            "segmented_minmax": (ops.fused_groupby_minmax,
                                 smm.fused_groupby_minmax_plain)}


@pytest.fixture(scope="module")
def session():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have "
                    "no CPU mode")
    s = connect(tier="local", quota=8)
    catalog = s.ensure_tpch(sf=0.01, n_parts=4)
    yield s, catalog, _tables(s, catalog)["lineitem"]
    s.close()


def _tables(s, catalog):
    ih = InputHandler(s.store)
    out = {}
    for name in ("lineitem", "orders", "part", "customer"):
        parts = [ih.read_table(f)[0] for f in catalog.tables[name].files]
        out[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                     for c in catalog.tables[name].schema}
    return out


def _match(s, sql):
    from repro_torch.core.engine import QueryEngine
    plan = QueryEngine(s.store, s.catalog, platform=s.platform,
                       handler=s.handler).plan_sql(sql)
    return next(lower.match_fragment(p.op) for p in plan.pipelines.values()
                if p.kernel)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("query", sorted(SQLS))
def test_kernel_matches_plain(session, query, capacity):
    s, _, lineitem = session
    m = _match(s, SQLS[query])
    wrapper, plain = WRAPPERS[m.kernel]
    n = min(capacity, len(lineitem["l_orderkey"]))
    dev = torch.device("cuda", 0)
    cols = {c: torch.zeros(capacity, dtype=torch.from_numpy(lineitem[c]).dtype,
                           device=dev) for c in m.program.names}
    for c in cols:
        cols[c][:n] = torch.from_numpy(lineitem[c][:n]).to(dev)
    mask = torch.zeros(capacity, dtype=torch.bool, device=dev)
    mask[:n] = True
    counter = {"filter_agg": "filter_agg", "groupby_onehot": "groupby",
               "segmented_minmax": "groupby_minmax"}[m.kernel]
    before = ext.launches().get(counter, 0)
    got = wrapper(cols, mask, program=m.program, tiling=m.tiling)
    want = plain(cols, mask, program=m.program)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float64
    assert ext.launches().get(counter, 0) == before + 1
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if m.kernel != "filter_agg":
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


def _nested_sum(names, op="+"):
    """c0 op (c1 op (c2 op ...)): the postfix program pushes every column
    before its first operator, a stack as deep as there are columns."""
    e = _col(names[-1])
    for n in reversed(names[:-1]):
        e = {"t": "bin", "op": op, "l": _col(n), "r": e}
    return e


@pytest.mark.parametrize("depth", [3, 6, 11, 15])
@pytest.mark.parametrize("grouped", [False, True])
def test_interpreter_stack_depths_match_plain(session, depth, grouped):
    """The interpreter's stack at each depth up to the column limit
    against the plain version, in the predicate and the aggregate
    arguments."""
    rng = np.random.default_rng(depth + grouped)
    dev = torch.device("cuda", 0)
    n = 1 << 16
    names = [f"c{i}" for i in range(depth)]
    cols = {c: torch.from_numpy(rng.normal(size=n)).to(dev) for c in names}
    cols["g"] = torch.from_numpy(rng.integers(0, 4, n).astype(
        np.int32)).to(dev)
    pred = {"t": "cmp", "op": ">", "l": _nested_sum(names), "r": _lit(0)}
    aggs = [("sum", _nested_sum(names, "*")), ("count", None),
            ("max", _nested_sum(names, "-"))]
    prog = compile_program([pred], aggs,
                           group_cols=["g"] if grouped else None,
                           strides=[1] if grouped else None,
                           n_groups=4 if grouped else 0)
    assert prog.depth == depth
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    kernel = "segmented_minmax" if grouped else "filter_agg"
    tiling = (roofline.groupby_tiling(kernel, n_cols=depth + 1, n_aggs=3,
                                      n_groups=4) if grouped
              else roofline.filter_agg_tiling(n_cols=depth, n_aggs=3))
    wrapper, plain = WRAPPERS[kernel]
    got = wrapper(cols, mask, program=prog, tiling=tiling)
    want = plain(cols, mask, program=prog)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if grouped:
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("query", sorted(SQLS))
def test_query_on_the_card_equals_the_oracle(session, query):
    s, catalog, lineitem = session
    assert s.device.type == "cuda"
    res = s.sql(SQLS[query])
    stage0 = [p for p in res.stats.pipelines if p.kernel]
    assert stage0 and stage0[0].kernel_fragments == stage0[0].n_fragments
    lqp, _ = Binder(catalog).bind(parse(SQLS[query]))
    want = oracle.run(optimize(lqp), {"lineitem": lineitem})
    got = res.fetch(s.store)
    keys = sorted(want)
    assert sorted(got) == keys
    order_g = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    order_w = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64)[order_g],
                                   np.asarray(want[k], np.float64)[order_w],
                                   **TOL)


def _join_block(capacity: int, seed: int):
    """A probe block and a sorted build side of ``capacity`` rows each:
    masked rows on both sides, sentinel probe keys, int32 payload."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    keys = rng.permutation(2 * capacity)[:capacity].astype(np.int64)
    bmask = rng.random(capacity) < 0.8
    bk = torch.from_numpy(np.where(bmask, keys, np.iinfo(np.int64).max))
    sk, order = torch.sort(bk.to(dev), stable=True)
    pay = {"g": torch.from_numpy(rng.integers(0, 5, capacity).astype(
        np.int32)).to(dev)[order],
           "q": torch.from_numpy(rng.normal(size=capacity)).to(dev)[order]}
    pk = rng.integers(-3, 2 * capacity, capacity).astype(np.int64)
    pk[rng.random(capacity) < 0.05] = np.iinfo(np.int64).max
    probe = {"k": torch.from_numpy(pk).to(dev),
             "x": torch.from_numpy(rng.normal(size=capacity)).to(dev),
             "d": torch.from_numpy(rng.integers(0, 100, capacity).astype(
                 np.int32)).to(dev)}
    pmask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    return probe, pmask, sk, pay


def _col(n):
    return {"t": "col", "name": n}


def _lit(v):
    return {"t": "lit", "value": v, "kind": "num"}


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("n_groups", [0, 5])
def test_join_kernel_matches_plain(session, capacity, n_groups):
    probe, pmask, sk, pay = _join_block(capacity, seed=capacity + n_groups)
    aggs = [("sum", {"t": "bin", "op": "*", "l": _col("x"), "r": _col("q")}),
            ("count", None), ("min", _col("q")),
            ("max", {"t": "bin", "op": "/", "l": _col("d"), "r": _lit(7)})]
    prog = compile_program(
        [{"t": "cmp", "op": "<", "l": _col("d"), "r": _lit(80)}], aggs,
        group_cols=["g"] if n_groups else None,
        strides=[1] if n_groups else None, n_groups=n_groups)
    tiling = roofline.join_probe_tiling(n_cols=3, n_payload=2, n_aggs=4,
                                        n_groups=n_groups)
    before = ext.launches().get("join_probe_agg", 0)
    got = ops.fused_join_probe_agg(probe, pmask, sk, pay, probe_key="k",
                                   program=prog, tiling=tiling)
    want = jp.fused_join_probe_agg_plain(probe, pmask, sk, pay,
                                         probe_key="k", program=prog)
    torch.cuda.synchronize()
    assert ext.launches().get("join_probe_agg", 0) == before + 1
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if n_groups:
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


# probe-side predicates on the probe block of _join_block (d in [0, 100)):
# one that rejects every row, one that accepts every row, a selective one;
# the residual reads the payload
_PROBE_PREDS = {
    "rejects all": [{"t": "cmp", "op": "<", "l": _col("d"), "r": _lit(0)}],
    "accepts all": [{"t": "cmp", "op": ">=", "l": _col("d"),
                     "r": _lit(0)}],
    "selective": [{"t": "cmp", "op": "<", "l": _col("d"), "r": _lit(7)}],
    "residual only": [],
}


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("n_groups", [0, 5])
@pytest.mark.parametrize("probe", sorted(_PROBE_PREDS))
def test_join_kernel_probe_predicate_matches_plain(session, capacity,
                                                   n_groups, probe):
    """The probe-predicate slot: the kernel runs it before the key search
    (none of a rejected row's key, search or payload is read), and the
    result equals the plain version's, where the slot is applied after
    the search."""
    probe_cols, pmask, sk, pay = _join_block(capacity,
                                             seed=capacity + n_groups + 7)
    aggs = [("sum", {"t": "bin", "op": "*", "l": _col("x"), "r": _col("q")}),
            ("count", None), ("max", _col("q"))]
    prog = compile_program(
        [{"t": "cmp", "op": ">", "l": _col("q"), "r": _lit(-0.5)}], aggs,
        group_cols=["g"] if n_groups else None,
        strides=[1] if n_groups else None, n_groups=n_groups,
        probe_preds=_PROBE_PREDS[probe])
    tiling = roofline.join_probe_tiling(n_cols=3, n_payload=2, n_aggs=3,
                                        n_groups=n_groups)
    before = ext.launches().get("join_probe_agg", 0)
    got = ops.fused_join_probe_agg(probe_cols, pmask, sk, pay,
                                   probe_key="k", program=prog,
                                   tiling=tiling)
    want = jp.fused_join_probe_agg_plain(probe_cols, pmask, sk, pay,
                                         probe_key="k", program=prog)
    torch.cuda.synchronize()
    assert ext.launches().get("join_probe_agg", 0) == before + 1
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if n_groups:
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
        assert (g[:, -1].sum() == 0) == (probe == "rejects all")
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("bits", [1 << 10, 1 << 22])
def test_bloom_kernel_matches_plain(session, capacity, bits):
    rng = np.random.default_rng(bits + capacity)
    dev = torch.device("cuda", 0)
    members = rng.integers(0, 1 << 20, 5000)
    words = bloom.words_tensor(bloom.bloom_build(
        members.astype(np.uint32), bits), dev)
    keys = np.concatenate([members[:100], rng.integers(
        -(1 << 40), 1 << 40, capacity - 100)]).astype(np.int64)
    keys = torch.from_numpy(keys).to(dev)
    mask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    before = ext.launches().get("bloom_filter", 0)
    got = ops.fused_bloom_filter(keys, mask, words=words, bits=bits, k=6,
                                 tiling=roofline.bloom_probe_tiling())
    want = bloom.fused_bloom_filter_plain(keys, mask, words=words,
                                          bits=bits, k=6)
    torch.cuda.synchronize()
    assert ext.launches().get("bloom_filter", 0) == before + 1
    assert torch.equal(got, want)


# the semi-join tests' selective join, grouped by a dictionary-coded
# column so that every stage runs a ported kernel arm
SELECTIVE_JOIN = (
    "select o_orderpriority, sum(l_extendedprice) as rev "
    "from lineitem, orders "
    "where l_orderkey = o_orderkey and o_totalprice > 500000 "
    "group by o_orderpriority")


@pytest.mark.parametrize("query", ["q12", "q14", "q19", "semijoin"])
def test_join_query_on_the_card_equals_the_oracle(session, query):
    s, catalog, _ = session
    from repro_torch.core.engine import QueryEngine
    sql = SELECTIVE_JOIN if query == "semijoin" else QUERIES[query]
    if query == "semijoin":     # repartition join, filter forced on
        cfg = CoordinatorConfig(
            planner=PlannerConfig(broadcast_threshold_bytes=1,
                                  exchange_partitions=4),
            use_result_cache=False, pipelined=False, adaptive=False)
        eng = QueryEngine(s.store, catalog, platform=s.platform,
                          config=cfg, handler=s.handler)
        plan = eng.plan_sql(sql)
        (probe,) = [p for p in plan.pipelines.values()
                    if p.params.semijoin]
        probe.params.semijoin["enabled"] = True
        before = ext.launches().get("bloom_filter", 0)
        res = eng.execute_plan(plan)
        assert ext.launches().get("bloom_filter", 0) > before
        pr = next(r for r in res.stats.pipelines if r.pid == probe.pid)
        assert pr.kernel_fragments == pr.n_fragments
        assert pr.semijoin_killed > 0
        assert not any("not yet ported" in p.kernel_miss_reason
                       for p in res.stats.pipelines)
    else:
        res = s.sql(sql)
        (join,) = [p for p in res.stats.pipelines if p.kernel]
        assert join.kernel == "join_probe_agg"
        assert join.kernel_fragments == join.n_fragments
    lqp, _ = Binder(catalog).bind(parse(sql))
    want = oracle.run(optimize(lqp), _tables(s, catalog))
    got = res.fetch(s.store)
    keys = sorted(want)
    assert sorted(got) == keys
    order_g = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    order_w = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64)[order_g],
                                   np.asarray(want[k], np.float64)[order_w],
                                   **TOL)


def _sort_block(capacity: int, seed: int, n_keys: int):
    """Int64 keys with ties and a few INT64_MAX keys, f64 values with NaN
    and inf in masked rows, a mask."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    mask = rng.random(capacity) < 0.8
    keys = []
    for _ in range(n_keys):
        k = rng.integers(0, max(capacity // 8, 2), capacity)
        k[rng.random(capacity) < 0.01] = np.iinfo(np.int64).max
        keys.append(torch.from_numpy(k.astype(np.int64)).to(dev))
    v = rng.normal(size=capacity)
    v[~mask & (rng.random(capacity) < 0.3)] = np.nan
    v[~mask & (rng.random(capacity) < 0.3)] = np.inf
    return keys, torch.from_numpy(v).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("n_keys", [1, 2])
def test_sort_agg_kernel_matches_plain(session, capacity, n_keys):
    keys, v, mask = _sort_block(capacity, capacity + n_keys, n_keys)
    fns = ["sum", "count", "min", "max"]
    values = [v, None, v, v]
    tiling = roofline.sort_tiling("sort_agg", n_keys=n_keys)
    before = ext.launches().get("sort_agg", 0)
    got = ops.fused_sort_agg(keys, values, fns, mask, tiling=tiling)
    want = sa.fused_sort_agg_plain(keys, values, fns, mask)
    torch.cuda.synchronize()
    assert ext.launches().get("sort_agg", 0) == before + 1
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 1
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   equal_nan=True, **TOL)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("limit", [10, 1 << 17])
def test_topk_kernel_matches_plain(session, capacity, limit):
    rng = np.random.default_rng(capacity + limit)
    dev = torch.device("cuda", 0)
    rev = rng.normal(size=capacity).round(1)
    rev[::7] = -0.0                         # ties of -0.0 with +0.0
    cols = {"rev": torch.from_numpy(rev).to(dev),
            "d": torch.from_numpy(rng.integers(0, 5, capacity).astype(
                np.int32)).to(dev),
            "k": torch.from_numpy(rng.integers(0, 1 << 40, capacity)).to(
                dev),
            "b": torch.from_numpy(rng.random(capacity) < 0.5).to(dev)}
    mask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    sort_keys = [("rev", True), ("d", False)]
    tiling = roofline.sort_tiling("topk", n_keys=2)
    before = ext.launches().get("topk", 0)
    got, gmask = ops.fused_topk(cols, mask, sort_keys=sort_keys,
                                limit=limit, tiling=tiling)
    want, wmask = tk.fused_topk_plain(cols, mask, sort_keys=sort_keys,
                                      limit=limit)
    torch.cuda.synchronize()
    assert ext.launches().get("topk", 0) == before + 1
    assert list(got) == list(want) and torch.equal(gmask, wmask)
    for c in want:
        assert got[c].dtype == want[c].dtype
        if got[c].is_floating_point():      # bit for bit, -0.0 included
            assert torch.equal(got[c].view(torch.int64),
                               want[c].view(torch.int64))
        else:
            assert torch.equal(got[c], want[c])


def _edge_keys(kind: str, capacity: int, rng) -> np.ndarray:
    """A key column for the radix sort's edge cases: every row equal (no
    live digit), the int64 extremes, or ties."""
    if kind == "equal":
        return np.full(capacity, -3, np.int64)
    if kind == "extremes":
        return rng.choice(np.array([np.iinfo(np.int64).min,
                                    np.iinfo(np.int64).max, -1, 0, 1],
                                   np.int64), capacity)
    return rng.integers(-5, max(capacity // 4, 2), capacity).astype(np.int64)


@pytest.mark.parametrize("capacity,kinds", [
    (1, ["ties"]), (1 << 12, ["equal"]), (1 << 12, ["extremes"]),
    (1 << 13, ["ties", "extremes", "ties"]), (1 << 13, ["equal", "ties"]),
    (1 << 16, ["extremes", "equal", "ties"]),
])
def test_sort_agg_radix_edge_cases_match_plain(card, capacity, kinds):
    """The radix sort under sort_agg lane for lane against the plain
    version: one row, one and two radix blocks (2^12, 2^13), all-equal
    keys (no live pass), INT64_MIN / INT64_MAX keys, 3 key lanes."""
    rng = np.random.default_rng(capacity + len(kinds))
    dev = torch.device("cuda", 0)
    keys = [torch.from_numpy(_edge_keys(k, capacity, rng)).to(dev)
            for k in kinds]
    v = torch.from_numpy(rng.normal(size=capacity)).to(dev)
    mask = torch.from_numpy(rng.random(capacity) < 0.8).to(dev)
    fns = ["sum", "count", "min", "max"]
    values = [v, None, v, v]
    tiling = roofline.sort_tiling("sort_agg", n_keys=len(keys))
    got = _launched("sort_agg", lambda: ops.fused_sort_agg(
        keys, values, fns, mask, tiling=tiling))
    want = sa.fused_sort_agg_plain(keys, values, fns, mask)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   equal_nan=True, **TOL)


@pytest.mark.parametrize("capacity", [1, 1 << 12, 1 << 13])
@pytest.mark.parametrize("descending", [False, True])
def test_topk_radix_float_keys_match_plain(card, capacity, descending):
    """f64 sort keys with -0.0, NaN and ±inf, ascending and descending,
    over int64 extremes and all-equal columns, lane for lane (floats bit
    for bit) against the plain version."""
    rng = np.random.default_rng(capacity + descending)
    dev = torch.device("cuda", 0)
    f = rng.normal(size=capacity).round(1)
    f = np.where(rng.random(capacity) < 0.4, rng.choice(np.array(
        [-0.0, 0.0, np.nan, np.inf, -np.inf]), capacity), f)
    cols = {"f": torch.from_numpy(f).to(dev),
            "i": torch.from_numpy(_edge_keys("extremes", capacity, rng)).to(
                dev),
            "e": torch.from_numpy(_edge_keys("equal", capacity, rng)).to(
                dev)}
    mask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    for sort_keys in ([("f", descending)], [("e", descending)],
                      [("i", not descending), ("f", descending),
                       ("e", False)]):
        got, gmask = _launched("topk", lambda: ops.fused_topk(
            cols, mask, sort_keys=sort_keys, limit=7,
            tiling=roofline.sort_tiling("topk", n_keys=len(sort_keys))))
        want, wmask = tk.fused_topk_plain(cols, mask, sort_keys=sort_keys,
                                          limit=7)
        assert torch.equal(gmask, wmask)
        for c in want:
            g, w = got[c], want[c]
            if g.is_floating_point():
                g, w = g.view(torch.int64), w.view(torch.int64)
            assert torch.equal(g, w), (sort_keys, c)


SORTAGG_SQL = ("select l_orderkey, sum(l_quantity) as s, count(*) as c "
               "from lineitem group by l_orderkey order by l_orderkey")


@pytest.mark.parametrize("query", ["sortagg", "q3"])
def test_sort_query_on_the_card_equals_the_oracle(session, query):
    """The GROUP BY l_orderkey's stage 0 runs sort_agg; Q3's final runs
    topk under the benchmark suites' planner (at SF 0.01 the default
    planner folds the final into the merge stage)."""
    s, catalog, _ = session
    from repro_torch.core.engine import QueryEngine
    kernel = {"sortagg": "sort_agg", "q3": "topk"}[query]
    sql = SORTAGG_SQL if query == "sortagg" else QUERIES["q3"]
    cfg = CoordinatorConfig(planner=PlannerConfig(
        bytes_per_worker=500_000, broadcast_threshold_bytes=250_000,
        exchange_partitions=4))
    eng = QueryEngine(s.store, catalog, platform=s.platform, config=cfg,
                      handler=s.handler)
    before = ext.launches().get(kernel, 0)
    res = eng.execute_plan(eng.plan_sql(sql))
    (p,) = [p for p in res.stats.pipelines if p.kernel]
    assert p.kernel == kernel and p.kernel_fragments == p.n_fragments
    assert ext.launches().get(kernel, 0) >= before + p.n_fragments
    assert not any("not yet ported" in r.kernel_miss_reason
                   for r in res.stats.pipelines)
    lqp, _ = Binder(catalog).bind(parse(sql))
    want = oracle.run(optimize(lqp), _tables(s, catalog))
    got = res.fetch(s.store)
    keys = sorted(want)
    assert sorted(got) == keys
    order_g = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    order_w = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64)[order_g],
                                   np.asarray(want[k], np.float64)[order_w],
                                   **TOL)


# -- the kernels no query reaches: Q6 and grouped sums at fixed layout, the
# model kernels (flash attention, the SSD scan)

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have "
                    "no CPU mode")
    return torch.device("cuda", 0)


def _launched(name, fn):
    before = ext.launches().get(name, 0)
    out = fn()
    torch.cuda.synchronize()
    assert ext.launches().get(name, 0) == before + 1
    return out


@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_filter_agg_q6_kernel_matches_plain(card, n):
    rng = np.random.default_rng(n)
    ship = torch.from_numpy(rng.integers(8000, 10000, n).astype(
        np.int32)).to(card)
    disc = torch.from_numpy((rng.integers(0, 11, n) / 100).astype(
        np.float32)).to(card)
    qty = torch.from_numpy(rng.integers(1, 51, n).astype(np.float32)).to(
        card)
    price = torch.from_numpy(rng.random(n).astype(np.float32) * 1e4).to(card)
    bounds = dict(date_lo=8500, date_hi=9500, disc_lo=0.05, disc_hi=0.07,
                  qty_hi=24.0)
    got = _launched("filter_agg_q6", lambda: ops.filter_agg(
        ship, disc, qty, price, **bounds))
    want = fa.filter_agg_plain(ship, disc, qty, price, **bounds)
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert float(got[1]) == float(want[1]) > 0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)


@pytest.mark.parametrize("n,K,A", [(5000, 6, 5), (1 << 20, 120, 5)])
def test_groupby_onehot_kernel_matches_plain(card, n, K, A):
    rng = np.random.default_rng(n + K)
    gid = rng.integers(-1, K + 1, n).astype(np.int32)   # -1 and K: no group
    gid = torch.from_numpy(gid).to(card)
    vals = torch.from_numpy(rng.standard_normal((n, A)).astype(
        np.float32)).to(card)
    got = _launched("groupby_onehot", lambda: ops.groupby_onehot(
        gid, vals, n_groups=K))
    want = go.groupby_onehot_plain(gid, vals, n_groups=K)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,hd,heads,kv_heads,causal,window", [
    (200, 64, 8, 2, True, 0), (256, 128, 2, 2, False, 0),
    (64, 64, 4, 1, True, 0), (300, 64, 4, 4, True, 100),
])
def test_flash_attention_kernel_matches_plain(card, dtype, S, hd, heads,
                                              kv_heads, causal, window):
    from repro_torch.kernels import flash_attention as fl
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((h, S, hd)).astype(
        np.float32)).to(card, dtype) for h in (heads, kv_heads, kv_heads))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    want = fl.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        # the kernel's float32 math rounded once: within half a bf16 ulp
        # (2^-8 of the value) of the float32 result on the same inputs
        exact = fl.flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   exact.cpu().numpy(), atol=2e-5,
                                   rtol=2.0 ** -8)


@pytest.mark.parametrize("S,hd,heads,kv_heads,causal,window", [
    (256, 128, 4, 2, True, 0), (333, 128, 2, 2, True, 0),
    (200, 64, 8, 2, True, 0), (40, 64, 4, 2, True, 0),
    (50, 128, 2, 1, False, 0), (1024, 64, 8, 8, True, 0),
    (777, 64, 5, 1, True, 256), (640, 128, 4, 2, True, 100),
    (1000, 64, 8, 2, False, 0), (513, 128, 4, 4, False, 0),
])
def test_flash_attention_bf16_tensor_cores_within_half_ulp(
        card, S, hd, heads, kv_heads, causal, window):
    """The bf16 tensor-core kernel (split-bf16 P) against the float32
    plain result on the same bf16 inputs at chip_smoke.py's check (rtol
    2^-8, atol 2e-5): head dims 64 and 128, ragged S, S below one tile,
    group 1, windows and non-causal."""
    from repro_torch.kernels import flash_attention as fl
    rng = np.random.default_rng(S * hd + heads)
    q, k, v = (torch.from_numpy(rng.standard_normal((h, S, hd)).astype(
        np.float32)).to(card, torch.bfloat16)
        for h in (heads, kv_heads, kv_heads))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    exact = fl.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exact.cpu().numpy(), atol=2e-5,
                               rtol=2.0 ** -8)


@pytest.mark.parametrize("draw", ["unit", "mamba2"])
@pytest.mark.parametrize("b,S,H,N,chunk", [(2, 1000, 3, 128, 256),
                                           (1, 256, 4, 16, 64),
                                           (1, 100, 2, 32, 256),
                                           # one chunk, S below a strip
                                           (2, 40, 3, 64, 256),
                                           # chunk 1024: four key blocks
                                           (1, 2048, 2, 128, 1024),
                                           # S not a multiple of 1024
                                           (2, 1500, 3, 64, 1024),
                                           # one head: b·H below a group
                                           (1, 700, 1, 16, 128),
                                           # chunks not a multiple of 64
                                           (2, 333, 5, 32, 100)])
def test_ssd_scan_kernel_matches_plain(card, b, S, H, N, chunk, draw):
    """``unit``: the reference's test draw (dt near 0.8, A near -1, a
    memory of a few tokens); ``mamba2``: mamba2-130m's dynamics (dt
    log-uniform in [1e-3, 0.1], A in [-16, -1]), whose long memory
    reaches the off-diagonal tiles and the state carried across chunks."""
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(S + N)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(card)
    x = f32(rng.standard_normal((b, S, H, 64)) * 0.5)
    if draw == "mamba2":
        dt = f32(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, S, H))))
        A_log = f32(np.log(rng.uniform(1.0, 16.0, H)))
    else:
        dt = f32(np.log1p(np.exp(rng.standard_normal((b, S, H)))))
        A_log = f32(rng.standard_normal(H) * 0.3)
    B = f32(rng.standard_normal((b, S, N)) * 0.5)
    C = f32(rng.standard_normal((b, S, N)) * 0.5)
    got = _launched("ssd_scan", lambda: ops.ssd_scan(x, dt, A_log, B, C,
                                                     chunk=chunk))
    want = ssd.ssd_scan_plain(x, dt, A_log, B, C, chunk=chunk)
    err = (got - want).abs().max().item()
    assert err / (want.abs().max().item() + 1e-9) < 5e-5


def test_ssd_scan_runs_on_the_tensor_cores(card):
    """The SSD library's SASS holds TF32 tensor-core instructions."""
    assert ext.sass("ssd_scan").count("HMMA") > 0


def test_model_kernel_wrappers_refuse_what_the_kernels_do_not_take(card):
    n = 64
    i32 = torch.zeros(n, dtype=torch.int32, device=card)
    f32 = torch.zeros(n, dtype=torch.float32, device=card)
    with pytest.raises(ValueError):          # a float64 price column
        ops.filter_agg(i32, f32, f32, f32.double(), date_lo=0, date_hi=1,
                       disc_lo=0.0, disc_hi=1.0, qty_hi=1.0)
    with pytest.raises(ValueError):          # int64 group ids
        ops.groupby_onehot(i32.long(), f32[:, None], n_groups=4)
    with pytest.raises(ValueError):          # non-contiguous values
        ops.groupby_onehot(i32, torch.zeros((2, n), device=card).t(),
                           n_groups=4)
    q = torch.zeros((2, 16, 64), device=card)
    with pytest.raises(ValueError):          # float16
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):          # non-contiguous k
        ops.flash_attention(q, q.transpose(0, 1).contiguous().transpose(
            0, 1), q)
    with pytest.raises(ValueError):          # head dim 32
        ops.flash_attention(q[..., :32].contiguous(),
                            q[..., :32].contiguous(),
                            q[..., :32].contiguous())
    x = torch.zeros((1, 16, 2, 64), device=card)
    dt = torch.zeros((1, 16, 2), device=card)
    bc = torch.zeros((1, 16, 16), device=card)
    with pytest.raises(ValueError):          # float64 x
        ops.ssd_scan(x.double(), dt, dt[0, 0], bc, bc)
    with pytest.raises(ValueError):          # P = 32
        ops.ssd_scan(x[..., :32].contiguous(), dt, dt[0, 0], bc, bc)
