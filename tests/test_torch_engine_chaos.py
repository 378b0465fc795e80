"""The port's engine under ``test_chaos.py``'s sweeps, against the
reference's: the owner killed at each registry protocol step and at the
storage commit point under background fault noise (5 sites × 4 seeds on
Q3), all fault classes at once over 20 seeds on Q6, and an owner killed
right after its claim, re-driven with exactly one fleet's invocations.
Each schedule runs through ``repro`` and through ``repro_torch``
(fragments on the CPU) with the same seed; every run's sorted rows equal
both packages' fault-free rows and the port's oracle within
rtol = atol = 1e-9."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize

TOL = dict(rtol=1e-9, atol=1e-9)
KILL_SITES = ("registry.claim", "registry.begin_partial",
              "registry.publish_partial", "registry.finish_partial",
              "storage.commit")


def _pkg(name, **connect_kw):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        name=name, api=mod("api"), registry=mod("core.registry"),
        engine=mod("core.engine"), platform=mod("core.platform"),
        data=mod("data"), physical=mod("sql.physical"),
        storage=mod("storage"), kw=connect_kw)


REF = _pkg("repro")
PORT = _pkg("repro_torch", device="cpu")
PKGS = (REF, PORT)


def _config(pkg, **kw):
    # calibration off: no cross-run state, so invocation counts and plans
    # are the same in a reference run and a chaos run
    return pkg.engine.CoordinatorConfig(
        planner=pkg.physical.PlannerConfig(
            bytes_per_worker=250_000, broadcast_threshold_bytes=150_000,
            exchange_partitions=3),
        calibrate_selectivity=False, **kw)


def _fresh_db(pkg):
    store = pkg.storage.ObjectStore(tier="local", seed=0)
    return store, pkg.data.generate_tpch(store, sf=0.01, n_parts=4, seed=0)


def _run(pkg, qname, chaos_kw=None, **config_kw):
    """One execution on a fresh store: (columns, invocations, chaos
    engine). The rows are fetched with injection paused."""
    store, catalog = _fresh_db(pkg)
    platform = pkg.platform.FaasPlatform(quota=16, seed=0)
    chaos = None if chaos_kw is None else pkg.api.ChaosEngine(
        pkg.api.ChaosConfig(**chaos_kw))
    session = pkg.api.connect(
        store, catalog, platform=platform, config=_config(pkg, **config_kw),
        registry=pkg.registry.ResultRegistry(store, claim_ttl_s=0.25),
        chaos=chaos, max_concurrent_queries=4, **pkg.kw)
    try:
        res = session.submit(QUERIES[qname]).result(timeout=300)
        if chaos is None:
            cols = res.fetch(store)
        else:
            with chaos.pause():
                cols = res.fetch(store)
    finally:
        session.close()
        platform.close()
    return cols, platform.invocations, chaos


_FAULT_FREE = {}


def _fault_free(pkg, qname, pipelined=True):
    key = (pkg.name, qname, pipelined)
    if key not in _FAULT_FREE:
        _FAULT_FREE[key] = _run(pkg, qname, pipelined=pipelined)[:2]
    return _FAULT_FREE[key]


_ORACLE = {}


def _oracle(qname):
    if qname not in _ORACLE:
        store, catalog = _fresh_db(PORT)
        ih = PORT.storage.InputHandler(store)
        tables = {}
        for name, meta in catalog.tables.items():
            parts = [ih.read_table(f)[0] for f in meta.files]
            tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                            for c in meta.schema}
        lqp, _ = Binder(catalog).bind(parse(QUERIES[qname]))
        _ORACLE[qname] = oracle.run(optimize(lqp), tables)
    return _ORACLE[qname]


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


def _assert_recovered(qname, runs, ctx, pipelined=True):
    """Each package's chaos rows equal its own and the other package's
    fault-free rows and the oracle."""
    want = _oracle(qname)
    for pkg, cols in zip(PKGS, runs):
        for other in PKGS:
            _assert_same_rows(cols, _fault_free(other, qname, pipelined)[0],
                              f"{ctx}: {pkg.name} vs {other.name}")
        _assert_same_rows(cols, want, f"{ctx}: {pkg.name} vs oracle")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_point_sweep_recovers_to_parity(site, seed):
    """Owner death at every protocol step under background fault noise:
    recovery (TTL steal, partial-stream reset, fragment retry) converges
    to the fault-free Q3 rows in both packages."""
    runs = []
    for pkg in PKGS:
        cols, _, chaos = _run(pkg, "q3", dict(
            seed=seed, kill_points=(site,), get_error_prob=0.003,
            put_error_prob=0.003, worker_kill_prob=0.01), max_attempts=6)
        assert chaos.injected.get(f"kill:{site}") == 1, \
            f"{pkg.name}: kill point {site} never fired (seed={seed})"
        runs.append(cols)
    _assert_recovered("q3", runs, f"site={site} seed={seed}")


def test_claim_owner_death_runs_fleet_exactly_once():
    """An owner killed right after writing its claim leaves an orphan the
    re-drive TTL-steals: the platform sees exactly the fault-free
    invocation count, the same in both packages (barrier mode keeps the
    schedule sequential, so the count is exact)."""
    runs, counts = [], []
    for pkg in PKGS:
        _, want = _fault_free(pkg, "q6", pipelined=False)
        cols, inv, chaos = _run(pkg, "q6", dict(
            kill_points=("registry.claim",)), pipelined=False)
        assert chaos.injected.get("kill:registry.claim") == 1
        assert inv == want, f"{pkg.name}: {inv} invocations vs {want}"
        runs.append(cols)
        counts.append(inv)
    assert counts[1] == counts[0] > 0
    _assert_recovered("q6", runs, "claim-kill", pipelined=False)


@pytest.mark.parametrize("seed", range(20))
def test_probabilistic_chaos_sweep_parity(seed):
    """Transient GET/PUT errors, throttles, latency spikes, torn PUTs,
    cold-start storms and worker kills at once: every seed recovers to
    the fault-free Q6 rows in both packages."""
    runs = [_run(pkg, "q6", dict(
        seed=seed, get_error_prob=0.005, put_error_prob=0.005,
        throttle_prob=0.003, latency_spike_prob=0.05, torn_put_prob=0.005,
        cold_storm_prob=0.10, worker_kill_prob=0.02), max_attempts=6)[0]
        for pkg in PKGS]
    _assert_recovered("q6", runs, f"seed={seed}")
