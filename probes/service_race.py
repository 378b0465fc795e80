"""Count wrong rows when one statement runs several times at once with the
result cache off, on the card: the same TPC-H Q6, Q12 and Q3 for two
tenants through a ``QueryService`` (as ``tests/test_torch_cuda.py``'s
service case), per engine mode, against the port's oracle. Each
execution names its pipelines' results and partial streams for itself
(``QueryEngine._execution_names``), so every scenario should count 0;
under one shared name, pipelined runs that sized their fleets apart read
each other's objects.

Scenarios, each ``trials`` times, on TPC-H SF 0.01 (4 partitions):
- ``service-pipelined`` / ``service-barrier``: the service case, its
  session on the benchmark suites' planner with the cache off, in
  pipelined or barrier mode, on a store where the default planner's
  cached runs of the same statements left their results (as earlier
  tests leave them);
- ``service-pipelined-fresh``: the pipelined case on a new store each
  trial;
- ``session-pipelined``: six Q6 submitted at once to one such session,
  no service;
- ``cpu-service-pipelined``: the first scenario with ``device="cpu"``.

A request whose sorted rows differ from the oracle's (rtol = atol =
1e-9) is counted with its ratio to the truth. Prints a line a scenario
and, last, a JSON object of the counts.

    python3 probes/service_race.py [trials]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.api import connect  # noqa: E402
from repro_torch.core import CoordinatorConfig  # noqa: E402
from repro_torch.service import (QueryService, RequestLedger,  # noqa: E402
                                 TenantConfig)
from repro_torch.sql import oracle  # noqa: E402
from repro_torch.sql.logical import Binder  # noqa: E402
from repro_torch.sql.parser import parse  # noqa: E402
from repro_torch.sql.physical import PlannerConfig  # noqa: E402
from repro_torch.sql.queries import QUERIES  # noqa: E402
from repro_torch.sql.rules import optimize  # noqa: E402
from repro_torch.storage import InputHandler  # noqa: E402

NAMES = ("q6", "q12", "q3")
PLANNER = PlannerConfig(bytes_per_worker=500_000,
                        broadcast_threshold_bytes=250_000,
                        exchange_partitions=4)


def _store(with_history: bool):
    s = connect(tier="local", quota=8, device="cuda")
    catalog = s.ensure_tpch(sf=0.01, n_parts=4)
    if with_history:
        for q in NAMES:            # cached runs under the default planner
            s.sql(QUERIES[q])
    return s, catalog


def _truth(s, catalog):
    ih = InputHandler(s.store)
    tables = {}
    for name, meta in catalog.tables.items():
        parts = [ih.read_table(f)[0] for f in meta.files]
        tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                        for c in meta.schema}
    out = {}
    for q in NAMES:
        lqp, _ = Binder(catalog).bind(parse(QUERIES[q]))
        out[q] = oracle.run(optimize(lqp), tables)
    return out


def _wrong(got, want):
    """None if the sorted rows agree, else the first column's ratio."""
    keys = sorted(want)
    if sorted(got) != keys:
        return float("nan")
    og = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    ow = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        a = np.asarray(got[k], np.float64)[og]
        b = np.asarray(want[k], np.float64)[ow]
        if a.shape != b.shape or not np.allclose(a, b, rtol=1e-9,
                                                 atol=1e-9):
            return float(a.sum() / b.sum()) if b.sum() else float("nan")
    return None


def _service_run(s, catalog, truth, *, pipelined, device, tag):
    sess = connect(s.store, catalog, quota=16, max_concurrent_queries=4,
                   device=device,
                   config=CoordinatorConfig(planner=PLANNER,
                                            use_result_cache=False,
                                            pipelined=pipelined))
    try:
        with QueryService(sess, ledger=RequestLedger(
                s.store, namespace=f"probe-{tag}"), tenants=(
                TenantConfig("gold", weight=3.0, deadline_s=30.0),
                TenantConfig("bronze", budget_cents=100.0))) as svc:
            handles = [(q, svc.submit(QUERIES[q], tenant=t))
                       for t in ("gold", "bronze") for q in NAMES]
            return [(q, _wrong(h.fetch(timeout=300), truth[q]))
                    for q, h in handles]
    finally:
        sess.close()


def _session_run(s, catalog, truth):
    sess = connect(s.store, catalog, quota=16, max_concurrent_queries=8,
                   device="cuda",
                   config=CoordinatorConfig(planner=PLANNER,
                                            use_result_cache=False))
    try:
        handles = [sess.submit(QUERIES["q6"]) for _ in range(6)]
        return [("q6", _wrong(h.result(timeout=300).fetch(s.store),
                              truth["q6"])) for h in handles]
    finally:
        sess.close()


def main() -> int:
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("service_race: no CUDA device", file=sys.stderr)
        return 2
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    hist, catalog = _store(with_history=True)
    truth = _truth(hist, catalog)
    counts = {}
    scenarios = {
        "service-pipelined": lambda i: _service_run(
            hist, catalog, truth, pipelined=True, device="cuda",
            tag=f"p{i}"),
        "service-barrier": lambda i: _service_run(
            hist, catalog, truth, pipelined=False, device="cuda",
            tag=f"b{i}"),
        "service-pipelined-fresh": None,
        "session-pipelined": lambda i: _session_run(hist, catalog, truth),
        "cpu-service-pipelined": lambda i: _service_run(
            hist, catalog, truth, pipelined=True, device="cpu",
            tag=f"c{i}"),
    }
    for name, run in scenarios.items():
        t0 = time.perf_counter()
        n = bad = 0
        ratios = []
        for i in range(trials):
            if run is None:
                fresh, fcat = _store(with_history=False)
                try:
                    res = _service_run(fresh, fcat, _truth(fresh, fcat),
                                       pipelined=True, device="cuda",
                                       tag=f"f{i}")
                finally:
                    fresh.close()
            else:
                res = run(i)
            for q, r in res:
                n += 1
                if r is not None:
                    bad += 1
                    ratios.append((i, q, r))
        counts[name] = {"requests": n, "wrong": bad,
                        "examples": ratios[:8]}
        print(f"{name}: {bad} of {n} requests wrong "
              f"({time.perf_counter() - t0:.1f} s) {ratios[:8]}",
              flush=True)
    hist.close()
    print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
