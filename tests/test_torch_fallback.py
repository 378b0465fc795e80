"""The in-arm generic fallback of the port's sort-aggregate, join and
top-k arms (``exec/lower.py``), held against the reference's arms and
``sql/oracle.py``.

The reference drops to its same-semantics XLA path inside these arms
when a capacity is not a power of two or is past the arm's cap
(``repro/exec/lower.py``: ``_lower_sort_agg``, ``_lower_join_probe``,
``_lower_topk``); the port's kernel wrappers raise there, so the port's
arms must take the generic torch path first. Each branch is forced: a
capacity of 700 rows for the power-of-two check, and a monkeypatched cap
(``roofline.SORT_MAX_ROWS``, ``JOIN_MAX_BUILD_ROWS``,
``JOIN_MAX_PROBE_ROWS``) for the size checks, with the kernel dispatch
replaced by a function that raises, so a test passes only if no wrapper
is reached. Rows are compared at rtol = atol = 1e-9 (the reference's
row parity tolerance); queries run at SF 0.01 on the port's CPU path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import CoordinatorConfig as RefCoordinatorConfig
from repro.exec import lower as ref_lower
from repro.exec.batch import from_numpy as ref_from_numpy
from repro.sql.physical import PlannerConfig as RefPlannerConfig
import repro_torch.api as port_api
from repro_torch.analysis import roofline
from repro_torch.core import CoordinatorConfig
from repro_torch.exec import lower as port_lower
from repro_torch.exec.batch import from_numpy as port_from_numpy
from repro_torch.kernels import ops as kops
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler

TOL = dict(rtol=1e-9, atol=1e-9)
SORTAGG_SQL = ("select l_orderkey, sum(l_quantity) as s, count(*) as c "
               "from lineitem group by l_orderkey order by l_orderkey")
BENCH_PLANNER = dict(bytes_per_worker=500_000,
                     broadcast_threshold_bytes=250_000,
                     exchange_partitions=4)
WRAPPERS = ("fused_sort_agg", "fused_topk", "fused_join_probe_agg")


def col(n):
    return {"t": "col", "name": n}


def lit(v):
    return {"t": "lit", "value": v, "kind": "num"}


def _refuse(name):
    def call(*a, **k):
        raise AssertionError(f"{name} reached under a forced fallback")
    return call


@pytest.fixture
def no_wrappers(monkeypatch):
    for name in WRAPPERS:
        monkeypatch.setattr(kops, name, _refuse(name))


def _rows(cols, mask=None):
    """Valid rows sorted lexicographically over every column."""
    keys = sorted(cols)
    arrs = [np.asarray(cols[k].numpy() if torch.is_tensor(cols[k])
                       else cols[k], np.float64) for k in keys]
    if mask is not None:
        m = np.asarray(mask.numpy() if torch.is_tensor(mask) else mask,
                       bool)
        arrs = [a[m] for a in arrs]
    order = np.lexsort(arrs)
    return {k: a[order] for k, a in zip(keys, arrs)}


def _assert_same_rows(got, want, ctx):
    assert sorted(got) == sorted(want), ctx
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{ctx} :: {k}",
                                   **TOL)


# -- one block at a capacity that is not a power of two -----------------------

SCAN = {"t": "scan_table", "columns": ["g", "i", "x", "y"]}
SA_AGGS = [["s", "sum", {"t": "bin", "op": "*", "l": col("x"),
                         "r": col("y")}],
           ["c", "count", None], ["lo", "min", col("x")],
           ["hi", "max", col("i")]]
SA_PRED = {"t": "cmp", "op": "<", "l": col("y"), "r": lit(0.8)}
N = 700


def _blocks(cols, n, mask):
    rb, pb = ref_from_numpy(cols, n), port_from_numpy(cols, n, "cpu")
    return ({"in0": (rb.columns, rb.mask & jnp.asarray(mask))},
            {"in0": (pb.columns, pb.mask & torch.from_numpy(mask))})


def _block(seed):
    rng = np.random.default_rng(seed)
    cols = {"g": rng.integers(0, 40, N).astype(np.int64),
            "i": rng.integers(-3, 3, N).astype(np.int64),
            "x": rng.normal(size=N), "y": rng.random(N)}
    return cols, rng.random(N) < 0.8


def _lower_both(op):
    with ref_lower.interpret_gate_disabled():
        ref = ref_lower.lower_fragment(op)
    port = port_lower.lower_fragment(op)
    assert ref.kernel == port.kernel
    return ref, port


@pytest.mark.parametrize("group_cols", [["g"], ["i", "g"]])
def test_sort_agg_arm_falls_back_off_a_power_of_two(no_wrappers,
                                                    group_cols):
    cols, mask = _block(1)
    op = {"t": "partial_agg", "strategy": "sort", "group_cols": group_cols,
          "sizes": None, "aggs": SA_AGGS,
          "child": {"t": "filter", "pred": SA_PRED, "child": SCAN}}
    ref, port = _lower_both(op)
    assert port.kernel == "sort_agg"
    rblocks, pblocks = _blocks(cols, N, mask)
    want, wmask = ref.fn(rblocks)
    got, gmask = port.fn(pblocks)
    assert gmask.shape == (N,)
    _assert_same_rows(_rows(got, gmask), _rows(
        {k: np.asarray(v) for k, v in want.items()}, np.asarray(wmask)),
        "sort_agg at 700 rows")
    valid = mask & (cols["y"] < 0.8)
    assert int(gmask.sum()) == len({tuple(cols[c][r] for c in group_cols)
                                    for r in np.flatnonzero(valid)})


def test_sort_agg_arm_over_a_join_falls_back_off_a_power_of_two(
        no_wrappers):
    """The port's own arm over a join, where the reference's dispatch
    misses (its generic chain is the yardstick): at 700 probe rows the
    arm runs the join and then the generic sort-aggregate."""
    from repro.exec.fragment import _build as ref_build
    rng = np.random.default_rng(3)
    nb = 64
    probe = {"g": rng.integers(0, nb + 8, N).astype(np.int64),
             "x": rng.normal(size=N), "y": rng.random(N)}
    build = {"bk": rng.permutation(nb).astype(np.int64),
             "d": rng.integers(0, 9, nb).astype(np.int64)}
    mask = rng.random(N) < 0.9
    join = {"t": "join", "probe": {"t": "scan_exchange", "source": 0},
            "build": {"t": "scan_exchange", "source": 1},
            "probe_key": "g", "build_key": "bk", "payload": ["d"]}
    op = {"t": "partial_agg", "strategy": "sort", "group_cols": ["g", "d"],
          "sizes": None, "aggs": SA_AGGS[:3],
          "child": {"t": "filter", "pred": SA_PRED, "child": join}}
    with ref_lower.interpret_gate_disabled():
        assert ref_lower.lower_fragment(op) is None
    port = port_lower.lower_fragment(op)
    assert port.kernel == "sort_agg"
    rp, pp = ref_from_numpy(probe, N), port_from_numpy(probe, N, "cpu")
    rb, pb = ref_from_numpy(build, nb), port_from_numpy(build, nb, "cpu")
    leaves = []
    want, wmask = ref_build(op, leaves)(
        {"in0": (rp.columns, rp.mask & jnp.asarray(mask)),
         "in1": (rb.columns, rb.mask)})
    assert port.leaves == leaves
    got, gmask = port.fn({"in0": (pp.columns,
                                  pp.mask & torch.from_numpy(mask)),
                          "in1": (pb.columns, pb.mask)})
    assert gmask.shape == (N,) and int(gmask.sum()) > 1
    _assert_same_rows(_rows(got, gmask), _rows(
        {k: np.asarray(v) for k, v in want.items()}, np.asarray(wmask)),
        "sort_agg over a join at 700 rows")


def test_topk_arm_passes_the_batch_through_off_a_power_of_two(no_wrappers):
    rng = np.random.default_rng(2)
    cols = {"rev": rng.normal(size=N), "d": rng.integers(0, 4, N),
            "p": rng.integers(0, 3, N)}
    mask = rng.random(N) < 0.9
    scan = {"t": "scan_exchange", "source": 0}
    op = {"t": "final", "sort_keys": [["rev", True], ["d", False]],
          "limit": 10, "project": None,
          "child": {"t": "filter", "pred": {"t": "cmp", "op": ">",
                                            "l": col("p"), "r": lit(0)},
                    "child": scan}}
    ref, port = _lower_both(op)
    assert port.kernel == "topk"
    rblocks, pblocks = _blocks(cols, N, mask)
    want, wmask = ref.fn(rblocks)
    got, gmask = port.fn(pblocks)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(gmask.numpy(), mask & (cols["p"] > 0))
    for c in cols:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))


# -- whole queries under a forced cap -----------------------------------------

@pytest.fixture(scope="module")
def sessions():
    ref = ref_api.connect(tier="local", quota=8)
    port = port_api.connect(tier="local", quota=8, device="cpu")
    ref.ensure_tpch(sf=0.01, n_parts=4)
    catalog = port.ensure_tpch(sf=0.01, n_parts=4)
    ih = InputHandler(port.store)
    tables = {}
    for name in ("lineitem", "orders", "part", "customer"):
        meta = catalog.tables[name]
        parts = [ih.read_table(f)[0] for f in meta.files]
        tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                        for c in meta.schema}
    yield ref, port, catalog, tables
    ref.close()
    port.close()


def _check_query(sessions, port, ref, sql, kernels, ctx):
    _, _, catalog, tables = sessions
    res = port.sql(sql)
    got = _rows(res.fetch(port.store))
    assert [p.kernel for p in res.stats.pipelines if p.kernel] == kernels
    lqp, _ = Binder(catalog).bind(parse(sql))
    _assert_same_rows(got, _rows(oracle.run(optimize(lqp), tables)),
                      f"{ctx} vs oracle")
    _assert_same_rows(got, _rows(ref.sql(sql).fetch(ref.store)),
                      f"{ctx} vs repro")
    return res


def test_sortagg_query_falls_back_past_the_sort_cap(sessions, no_wrappers,
                                                    monkeypatch):
    ref, port, _, _ = sessions
    monkeypatch.setattr(roofline, "SORT_MAX_ROWS", 512)
    res = _check_query(sessions, port, ref, SORTAGG_SQL, ["sort_agg"],
                       "sortagg")
    got = res.fetch(port.store)
    assert got["l_orderkey"].tolist() == sorted(got["l_orderkey"].tolist())


def test_q3_final_falls_back_past_the_sort_cap(sessions, no_wrappers,
                                               monkeypatch):
    ref, port, _, _ = sessions
    monkeypatch.setattr(roofline, "SORT_MAX_ROWS", 512)
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
        # the join stage's sort_agg arm over joins falls back too
        res = _check_query(sessions, bench, rbench, QUERIES["q3"],
                           ["sort_agg", "topk"], "q3")
        rev = res.fetch(bench.store)["revenue"]
        assert len(rev) == 10 and list(rev) == sorted(rev, reverse=True)
    finally:
        bench.close()
        rbench.close()


@pytest.mark.parametrize("cap", ["JOIN_MAX_BUILD_ROWS",
                                 "JOIN_MAX_PROBE_ROWS"])
@pytest.mark.parametrize("query", ["q12", "q14", "q19"])
def test_join_queries_fall_back_past_the_join_cap(sessions, no_wrappers,
                                                  monkeypatch, query, cap):
    ref, port, _, _ = sessions
    monkeypatch.setattr(roofline, cap, 1)
    _check_query(sessions, port, ref, QUERIES[query], ["join_probe_agg"],
                 query)
