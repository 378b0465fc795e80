"""The port's engine matrix against the reference's: every TPC-H query of
``QUERIES``, the grouped min/max query and the GROUP BY ``l_orderkey``
query, under each exchange strategy, in barrier and pipelined mode, with
adaptive re-optimization off and on (``tests/test_pipelined.py``'s
planner), 96 configurations. Each runs through ``repro`` and through
``repro_torch`` (fragments on the CPU) on SF 0.01 with the result cache
off; sorted rows equal the reference's and the port's oracle within
rtol = atol = 1e-9, and both packages plan the same pipelines, each on
the reference's kernel where the reference runs one (its interpret-cost
gate keeps the sort arms off on the CPU; the port runs them there). In
barrier mode both packages also size each fleet alike and make the same
adaptations. Pipelined mode sizes fleets from partial manifests, and
whether a pipeline ran on partial input depends on timing in either
package, so neither is asserted there."""

import numpy as np
import pytest

import repro.api as ref_api
from repro.data import generate_tpch as ref_generate
from repro.sql.physical import PlannerConfig as RefPlanner
from repro.storage import ObjectStore as RefStore
import repro_torch.api as port_api
from repro_torch.data import generate_tpch as port_generate
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig as PortPlanner
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler
from repro_torch.storage import ObjectStore as PortStore

TOL = dict(rtol=1e-9, atol=1e-9)
SQL = dict(QUERIES,
           minmax="select l_returnflag, min(l_quantity) as mq, "
                  "max(l_tax) as mt from lineitem group by l_returnflag",
           sortagg="select l_orderkey, sum(l_quantity) as s, count(*) as c "
                   "from lineitem group by l_orderkey order by l_orderkey")
STRATEGIES = ("direct", "combining", "multilevel")


@pytest.fixture(scope="module")
def dbs():
    ref_store = RefStore(tier="local", seed=0)
    ref_catalog = ref_generate(ref_store, sf=0.01, n_parts=4, seed=0)
    port_store = PortStore(tier="local", seed=0)
    port_catalog = port_generate(port_store, sf=0.01, n_parts=4, seed=0)
    ih = InputHandler(port_store)
    tables = {}
    for name, meta in port_catalog.tables.items():
        parts = [ih.read_table(f)[0] for f in meta.files]
        tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                        for c in meta.schema}
    return (ref_store, ref_catalog), (port_store, port_catalog), tables


_ORACLE = {}


def _oracle(qname, catalog, tables):
    if qname not in _ORACLE:
        lqp, _ = Binder(catalog).bind(parse(SQL[qname]))
        _ORACLE[qname] = oracle.run(optimize(lqp), tables)
    return _ORACLE[qname]


def _run(api, planner_cls, store, catalog, sql, strategy, pipelined,
         adaptive, **kw):
    cfg = api.CoordinatorConfig(
        planner=planner_cls(bytes_per_worker=250_000,
                            broadcast_threshold_bytes=150_000,
                            exchange_partitions=3,
                            exchange_strategy=strategy),
        use_result_cache=False, adaptive=adaptive, pipelined=pipelined)
    with api.connect(store, catalog, config=cfg, quota=1000,
                     **kw) as session:
        res = session.submit(sql).result(timeout=300)
        return res.fetch(store), res.stats


def _sorted_rows(cols):
    keys = sorted(cols)
    arrs = [np.asarray(cols[k], np.float64) for k in keys]
    order = np.lexsort(arrs)
    return {k: a[order] for k, a in zip(keys, arrs)}


def _assert_same_rows(a, b, ctx):
    sa, sb = _sorted_rows(a), _sorted_rows(b)
    assert sorted(sa) == sorted(sb), ctx
    for k in sa:
        np.testing.assert_allclose(sa[k], sb[k], err_msg=f"{ctx} :: {k}",
                                   **TOL)


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["static", "adaptive"])
@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("qname", sorted(SQL))
def test_engine_matrix_rows_match_reference_and_oracle(dbs, qname, strategy,
                                                       pipelined, adaptive):
    (ref_store, ref_catalog), (port_store, port_catalog), tables = dbs
    ctx = f"{qname}/{strategy}/pipelined={pipelined}/adaptive={adaptive}"
    want, ref_stats = _run(ref_api, RefPlanner, ref_store, ref_catalog,
                           SQL[qname], strategy, pipelined, adaptive)
    got, port_stats = _run(port_api, PortPlanner, port_store, port_catalog,
                           SQL[qname], strategy, pipelined, adaptive,
                           device="cpu")
    _assert_same_rows(got, want, f"{ctx} vs repro")
    _assert_same_rows(got, _oracle(qname, port_catalog, tables),
                      f"{ctx} vs oracle")
    assert [p.pid for p in port_stats.pipelines] == \
        [p.pid for p in ref_stats.pipelines], ctx
    for mine, theirs in zip(port_stats.pipelines, ref_stats.pipelines):
        assert mine.kernel == theirs.kernel or not theirs.kernel, ctx
        if not pipelined:
            assert mine.n_fragments == theirs.n_fragments, ctx
            assert [a["kind"] for a in mine.adaptations] == \
                [a["kind"] for a in theirs.adaptations], ctx
