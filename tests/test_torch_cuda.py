"""The port on the card: each CUDA kernel against its plain version, and
the slice end to end on the default device.

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
from repro_torch.kernels import ext, ops
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import groupby_onehot as go
from repro_torch.kernels import segmented_minmax as smm
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
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
    ih = InputHandler(s.store)
    parts = [ih.read_table(f)[0] for f in catalog.tables["lineitem"].files]
    lineitem = {c.name: np.concatenate([p[c.name] for p in parts])
                for c in catalog.tables["lineitem"].schema}
    yield s, catalog, lineitem
    s.close()


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
