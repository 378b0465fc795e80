"""SQL query driver: the end-to-end Skyrise entry point.

Built on the public client API (``repro_torch.api``): one ``SkyriseSession``
owns the object store, the FaaS platform (with its concurrency quota),
and the semantic result cache; queries are *submitted* and run
concurrently against that shared infrastructure.

  PYTHONPATH=src python -m repro_torch.launch.sql --sf 0.05 --query q12
  PYTHONPATH=src python -m repro_torch.launch.sql --query q1,q6,q12   # concurrent
  PYTHONPATH=src python -m repro_torch.launch.sql --query q3 --explain
  PYTHONPATH=src python -m repro_torch.launch.sql --query q12 --analyze
  PYTHONPATH=src python -m repro_torch.launch.sql --sf 0.01 \
      --sql "select count(*) as n from lineitem where l_quantity < 10"
  PYTHONPATH=src python -m repro_torch.launch.sql --query q6 --device cpu

Fragments run on the CUDA card; ``--device cpu`` runs the kernels' plain
torch versions instead. Without a card and without ``--device cpu`` the
driver exits nonzero before it builds anything.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import ConsoleObserver, CoordinatorConfig, connect
from repro_torch.exec.batch import resolve_device
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES


def _print_result(session, handle, analyze: bool = False) -> None:
    res = handle.result()
    cols = res.fetch(session.store)
    s = res.stats

    if analyze:
        print(f"\n[{handle.query_id}] {handle.explain_analyze()}")
    print(f"\n[{handle.query_id}] result @ {res.locations}")
    names = [n for n in res.output_names if n in cols]
    print(" | ".join(f"{n:>16s}" for n in names))
    n_rows = len(next(iter(cols.values()))) if cols else 0
    for i in range(min(n_rows, 20)):
        print(" | ".join(f"{cols[n][i]:>16.4f}"
                         if np.issubdtype(cols[n].dtype, np.floating)
                         else f"{cols[n][i]:>16}" for n in names))
    if n_rows > 20:
        print(f"… {n_rows - 20} more rows")
    n_adapt = sum(len(p.adaptations) for p in s.pipelines)
    print(f"[{handle.query_id}] sim latency {s.sim_latency_s:.2f}s · wall "
          f"{s.wall_s:.2f}s · cost {s.cost.total_cents:.4f}¢ · "
          f"workers {sum(p.n_fragments for p in s.pipelines)} · "
          f"cache hits {s.cache_hits}/{len(s.pipelines)} · "
          f"adaptations {n_adapt}")


def _print_service_result(session, handle) -> None:
    res = handle.result()
    entry = handle.entry()
    cols = res.fetch(session.store)
    names = [n for n in res.output_names if n in cols]
    print(f"\n[{handle.request_id}] {entry.status.value} "
          f"(tenant={entry.tenant}, attempt={entry.attempt})")
    print(" | ".join(f"{n:>16s}" for n in names))
    n_rows = len(next(iter(cols.values()))) if cols else 0
    for i in range(min(n_rows, 20)):
        print(" | ".join(f"{cols[n][i]:>16.4f}"
                         if np.issubdtype(cols[n].dtype, np.floating)
                         else f"{cols[n][i]:>16}" for n in names))
    if n_rows > 20:
        print(f"… {n_rows - 20} more rows")
    slo = ""
    if entry.deadline_s is not None:
        slo = (f" · deadline {entry.deadline_s:g}s "
               f"{'MISSED' if res.deadline_missed else 'met'}")
    print(f"[{handle.request_id}] sim latency {res.sim_latency_s:.2f}s · "
          f"cost {res.cost_cents:.4f}¢ · "
          f"cache hits {res.cache_hits}{slo}")


def _run_service(session, statements, args) -> None:
    """Route the queries through the durable service tier so the CLI
    exercises ledger + admission + SLO plumbing end-to-end."""
    from repro_torch.service import QueryService, TenantConfig

    tenant = args.tenant or "cli"
    with QueryService(session, tenants=(TenantConfig(
            tenant, deadline_s=args.deadline,
            budget_cents=args.budget_cents),)) as svc:
        handles = [svc.submit(stmt, tenant=tenant) for stmt in statements]
        for handle in handles:
            _print_service_result(session, handle)
        st = svc.stats()
        t = st["tenants"][tenant]
        budget = ("unmetered" if t["budget_cents"] is None else
                  f"{t['window_spent_cents']:.4f}/{t['budget_cents']:g}¢")
        print(f"\n[sql] service {st['service_id']}: "
              f"{sum(st['requests_by_status'].values())} requests "
              f"{st['requests_by_status']} · tenant {tenant}: "
              f"budget {budget} · "
              f"throttled {t['throttled_admissions']} · "
              f"degraded {t['degraded_dispatches']} · "
              f"deadline misses {st['deadline_misses']}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--query", default="q12",
                    help="named TPC-H queries, comma-separated "
                         f"(concurrent); choices: {list(QUERIES)}")
    ap.add_argument("--sql", default=None)
    ap.add_argument("--store-dir", default=None,
                    help="persist the store on disk (reused across runs)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--tier", default="s3-standard")
    ap.add_argument("--quota", type=int, default=1000,
                    help="shared function-concurrency quota")
    ap.add_argument("--explain", action="store_true",
                    help="print physical plans without executing")
    ap.add_argument("--analyze", action="store_true",
                    help="EXPLAIN ANALYZE: execute, then print est vs "
                         "actual rows and barrier adaptations")
    ap.add_argument("--static", action="store_true",
                    help="disable adaptive re-optimization at stage "
                         "barriers (compile-time plan runs as-is)")
    ap.add_argument("--verbose", action="store_true",
                    help="trace pipeline/straggler/retry events")
    ap.add_argument("--tenant", default=None,
                    help="run through the query service tier as this "
                         "tenant (durable ledger + fair-share admission)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="SLO deadline in simulated seconds — drives "
                         "per-stage latency budgets for fleet sizing "
                         "(implies the service tier)")
    ap.add_argument("--budget-cents", type=float, default=None,
                    help="tenant cost budget in cents per window — "
                         "over-budget runs degrade, then throttle "
                         "(implies the service tier)")
    ap.add_argument("--device", default=None,
                    help="where fragments run: the CUDA card by default; "
                         "'cpu' runs the kernels' plain torch versions")
    args = ap.parse_args()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[sql] {e} (the CLI takes --device cpu)")

    cfg = CoordinatorConfig(
        planner=PlannerConfig(bytes_per_worker=512 << 10),
        use_result_cache=not args.no_cache,
        adaptive=not args.static)
    if args.sql:
        statements = [args.sql]
    else:
        names = [q.strip() for q in args.query.split(",") if q.strip()]
        unknown = [q for q in names if q not in QUERIES]
        if unknown:
            raise SystemExit(f"unknown queries {unknown}; "
                             f"choices: {list(QUERIES)}")
        statements = [QUERIES[q] for q in names]

    session = connect(store_dir=args.store_dir, tier=args.tier,
                      quota=args.quota, config=cfg,
                      observers=(ConsoleObserver(),) if args.verbose
                      else (), device=device)
    name = (f" ({torch.cuda.get_device_name(session.device)})"
            if session.device.type == "cuda" else "")
    print(f"[sql] device {session.device}{name}")
    if session.store.exists(f"tpch/sf{args.sf:g}/catalog"):
        print(f"[sql] reusing existing TPC-H sf={args.sf:g}")
    else:
        print(f"[sql] generating TPC-H sf={args.sf:g} …")
    session.ensure_tpch(sf=args.sf)

    if args.explain:
        for stmt in statements:
            print(session.explain(stmt))
        return

    if args.tenant or args.deadline is not None \
            or args.budget_cents is not None:
        with session:
            _run_service(session, statements, args)
        return

    with session:
        handles = [session.submit(stmt) for stmt in statements]
        for handle in handles:
            _print_result(session, handle, analyze=args.analyze)
        if len(handles) > 1:
            st = session.stats()
            print(f"\n[sql] session: {st['queries_submitted']} queries · "
                  f"{st['platform_invocations']} invocations · peak "
                  f"{st['max_workers_in_flight']}/{st['quota']} workers "
                  f"in flight")


if __name__ == "__main__":
    main()
