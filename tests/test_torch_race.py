"""Two live runs of one statement with the result cache off, in pipelined
mode, through one port session (fragments on the CPU): each run must
return the oracle's rows even when the two size their fleets apart.

With the cache off no registry claim dedupes the runs, so each execution
names its pipelines' results and partial streams for itself
(``QueryEngine._execution_names``). The runs are forced apart: the
second one's scan fleets take one worker more where a scan unit is left
over (else one fewer), and both wait for each other before every
pipeline's fleet launches, so their fleets write and read at the same
time. Under a shared name the two layouts mix, and a consumer reads the
other run's objects (duplicated or missing rows). The reference keeps
that fault (``repro/core/engine.py``), so the rows are held against the
port's oracle, not against ``repro``.
"""

import threading
from collections import defaultdict

import numpy as np
import pytest

from repro_torch.api import connect
from repro_torch.core import CoordinatorConfig
from repro_torch.core.engine import QueryEngine
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler

TOL = dict(rtol=1e-9, atol=1e-9)
PLANNER = PlannerConfig(bytes_per_worker=500_000,
                        broadcast_threshold_bytes=250_000,
                        exchange_partitions=4)


@pytest.fixture(scope="module")
def db():
    s = connect(tier="local", quota=16, max_concurrent_queries=4,
                device="cpu",
                config=CoordinatorConfig(planner=PLANNER,
                                         use_result_cache=False,
                                         pipelined=True,
                                         pipelined_wait_timeout_s=60.0))
    catalog = s.ensure_tpch(sf=0.01, n_parts=4)
    ih = InputHandler(s.store)
    tables = {}
    for name, meta in catalog.tables.items():
        parts = [ih.read_table(f)[0] for f in meta.files]
        tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                        for c in meta.schema}
    yield s, catalog, tables
    s.close()


def _sorted_rows(cols):
    keys = sorted(cols)
    arrs = [np.asarray(cols[k], np.float64) for k in keys]
    order = np.lexsort(arrs)
    return {k: a[order] for k, a in zip(keys, arrs)}


def _force_apart(monkeypatch, forced: list):
    """Patch the fleet sizing: every run waits for the other at each
    pipeline, just before its fleet launches, and the run whose query id
    is in ``forced`` takes one scan worker more where a scan unit is
    left over (else one fewer, if it has more than one)."""
    meet = defaultdict(lambda: threading.Barrier(2, timeout=30.0))
    lock = threading.Lock()
    orig = QueryEngine._apply_slo_fleet

    def sized(self, p, report):
        orig(self, p, report)
        with lock:
            barrier = meet[p.sem_hash]
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            pass
        n = p.params.n_fragments
        if self.query_id in forced and p.scan_units:
            p.params.n_fragments = n + 1 if n < len(p.scan_units) \
                else max(n - 1, 1)
            report.n_fragments = p.params.n_fragments
    monkeypatch.setattr(QueryEngine, "_apply_slo_fleet", sized)


@pytest.mark.parametrize("qname", ["q12", "q3"])
def test_two_live_runs_sized_apart_return_the_oracle_rows(db, qname,
                                                          monkeypatch):
    s, catalog, tables = db
    forced: list = []
    _force_apart(monkeypatch, forced)
    s.pause()
    try:
        first = s.submit(QUERIES[qname])
        second = s.submit(QUERIES[qname])
        forced.append(second.query_id)
    finally:
        s.resume()
    got = [h.result(timeout=300) for h in (first, second)]
    # the forcing took: the two runs' scan fleets differ
    fleets = [{r.pid: r.n_fragments for r in res.stats.pipelines}
              for res in got]
    assert fleets[0] != fleets[1], fleets
    lqp, _ = Binder(catalog).bind(parse(QUERIES[qname]))
    want = _sorted_rows(oracle.run(optimize(lqp), tables))
    for h, res in zip((first, second), got):
        rows = _sorted_rows(res.fetch(s.store))
        assert sorted(rows) == sorted(want), h.query_id
        for k in want:
            np.testing.assert_allclose(
                rows[k], want[k], err_msg=f"{qname} {h.query_id} :: {k}",
                **TOL)


def test_execution_names_follow_the_cache_setting(db):
    """Cache off: each drive names every pipeline of its plan apart, by
    query id and a fresh run token; cache on: the semantic hash."""
    s, catalog, _ = db
    kw = dict(platform=s.platform, handler=s.handler)
    off = QueryEngine(s.store, catalog, query_id="s9-q1",
                      config=CoordinatorConfig(planner=PLANNER,
                                               use_result_cache=False), **kw)
    plan = off.plan_sql(QUERIES["q12"])
    a, b = off._execution_names(plan), off._execution_names(plan)
    sems = {p.sem_hash for p in plan.pipelines.values()}
    assert set(a) == set(b) == sems
    for sem in sems:
        assert a[sem].startswith(f"{sem}@s9-q1-") and a[sem] != b[sem]
        assert "." not in a[sem]     # "." marks the partial streams' keys
    on = QueryEngine(s.store, catalog, query_id="s9-q2",
                     config=CoordinatorConfig(planner=PLANNER), **kw)
    assert on._execution_names(plan) == {}
    assert on._name(next(iter(sems))) == next(iter(sems))
