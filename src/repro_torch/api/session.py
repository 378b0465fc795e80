"""``SkyriseSession``: the unified multi-query client entry point.

The paper's coordinator owns exactly one query (section 3.1); the
*service* is multi-tenant — many queries share one FaaS concurrency
quota, one object store, and one semantic result cache (section 3.4). A
session owns those shared pieces once::

    from repro_torch.api import connect

    session = connect(quota=64)
    session.ensure_tpch(sf=0.01)
    handles = [session.submit(sql) for sql in queries]   # concurrent
    for h in handles:
        print(h.result().fetch(session.store))

``submit`` enqueues and returns a :class:`QueryHandle` immediately; a
small scheduler drives up to ``max_concurrent_queries`` per-query
engines. Their fragments run wall-clock-parallel on the platform's
thread pool, each holding one slot of the shared ``AdmissionController``
for exactly its own lifetime (per-fragment slot release) — so the
combined in-flight worker fleet of all queries never exceeds the
per-user quota, and a finished worker's slot immediately serves any
waiting query. Concurrent queries that want the same pipeline
(semantic hash) share one in-flight execution through the registry's
claim/publish/await_complete protocol instead of racing duplicates.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from repro_torch.core.cost import CostModel
from repro_torch.core.engine import (CoordinatorConfig, QueryCancelled,
                               QueryEngine, QueryResult)
from repro_torch.core.events import (ObserverMux, QueryObserver, emit_span,
                                     new_span_id)
from repro_torch.core.platform import FaasPlatform, FaultPlan
from repro_torch.core.registry import ResultRegistry
from repro_torch.core.worker import make_worker_handler
from repro_torch.data.catalog import Catalog
from repro_torch.storage.object_store import (FilesystemBackend, ObjectStore)

from repro_torch.api.handle import QueryHandle, QueryState

_session_counter = itertools.count()


class SkyriseSession:
    """Owns the shared serverless infrastructure of many queries."""

    def __init__(self, store: ObjectStore | None = None,
                 catalog: Catalog | None = None, *,
                 store_dir: str | None = None,
                 tier: str | None = None,
                 platform: FaasPlatform | None = None,
                 quota: int | None = None,
                 faults: FaultPlan | None = None,
                 config: CoordinatorConfig | None = None,
                 cost_model: CostModel | None = None,
                 registry: ResultRegistry | None = None,
                 chaos=None,
                 max_concurrent_queries: int = 4,
                 observers: tuple[QueryObserver, ...] = (),
                 seed: int = 0,
                 device=None):
        # Reject conflicting arguments instead of silently ignoring the
        # knobs a pre-built component absorbs.
        if platform is not None and (quota is not None
                                     or faults is not None):
            raise ValueError("pass either a platform or quota/faults "
                             "(set them on the platform), not both")
        if store is not None and (store_dir is not None
                                  or tier is not None):
            raise ValueError("pass either a store or store_dir/tier "
                             "(they configure the built store), not both")
        if store is None:
            backend = FilesystemBackend(store_dir) if store_dir else None
            store = ObjectStore(backend, tier=tier or "s3-standard",
                                seed=seed)
        self.store = store
        self.catalog = catalog
        # A platform this session built is also torn down by close();
        # an externally passed one may be shared with other sessions.
        self._owns_platform = platform is None
        self.platform = platform or FaasPlatform(
            quota=1000 if quota is None else quota, seed=seed,
            faults=faults)
        self.config = config or CoordinatorConfig()
        self.cost_model = cost_model or CostModel()
        # Chaos engine (core.chaos): one shared, seeded fault schedule
        # attached to the store (storage faults + registry/ledger kill
        # points ride on it) and the platform (storms, worker kills).
        self.chaos = chaos
        if chaos is not None:
            self.store.chaos = chaos
            self.platform.chaos = chaos
        # Shared across every query of the session: one result cache,
        # one worker handler (code package) whose SPAX footer cache spans
        # all fragments of all queries, one admission ledger.
        self.registry = registry if registry is not None \
            else ResultRegistry(store)
        if chaos is not None:
            # a registry built before this session snapshotted its KV
            # view (with_tier copies `chaos` at construction) — attach
            # the schedule to that view too so protocol kill points fire
            self.registry.store.chaos = chaos
        # ``device``: where every fragment of the session runs — the card
        # when None; with no CUDA only an explicit "cpu" is accepted
        self.handler = make_worker_handler(
            store, cost_model=(self.cost_model
                               if self.config.hedged_reads else None),
            device=device)
        self.device = self.handler.device
        self.footer_cache = self.handler.footer_cache
        self.observers = ObserverMux(list(observers))

        self.max_concurrent_queries = max(1, max_concurrent_queries)
        self._sid = next(_session_counter)
        self._qid = itertools.count()
        self._cv = threading.Condition()
        self._queue: deque[QueryHandle] = deque()
        self._threads: list[threading.Thread] = []
        self._active = 0
        self._paused = False
        self._closing = False
        self._handles: list[QueryHandle] = []

    # -- catalog management --------------------------------------------------
    def attach_catalog(self, catalog: Catalog) -> "SkyriseSession":
        self.catalog = catalog
        return self

    def ensure_tpch(self, sf: float = 0.01, *, n_parts: int | None = None,
                    seed: int = 0) -> Catalog:
        """Load the TPC-H catalog from the store, generating it first if
        absent (store-level idempotence: two sessions on one store share
        the dataset)."""
        key = f"tpch/sf{sf:g}/catalog"
        if self.store.exists(key):
            catalog = Catalog.load(self.store, key)
        else:
            from repro_torch.data import generate_tpch
            catalog = generate_tpch(self.store, sf=sf, n_parts=n_parts,
                                    seed=seed)
        self.attach_catalog(catalog)
        return catalog

    # -- query API -----------------------------------------------------------
    def submit(self, sql: str, priority: int = 0, *,
               tenant: str | None = None,
               deadline_s: float | None = None,
               fleet_cap: int | None = None) -> QueryHandle:
        """Enqueue a query; returns its handle immediately.

        ``priority`` orders the session scheduler *and* the platform's
        admission ledger: freed queue positions and worker slots go to
        the highest-priority waiting query (ties FIFO), with an aging
        bump per ``aging_interval_s`` waited (see ``AdmissionController``)
        so low-priority queries are delayed but never starved.

        The service tier (``repro_torch.service``) adds: ``tenant`` — the
        fair-share admission group the query's fragments charge;
        ``deadline_s`` — an SLO deadline in *simulated* seconds, split
        into per-stage latency budgets that drive fleet sizing;
        ``fleet_cap`` — a hard per-pipeline fleet clamp (degraded
        dispatch for over-budget tenants).
        """
        if self.catalog is None:
            raise RuntimeError("no catalog attached — call "
                               "attach_catalog() or ensure_tpch() first")
        handle = QueryHandle(f"s{self._sid}-q{next(self._qid)}", sql, self,
                             priority=priority, tenant=tenant,
                             deadline_s=deadline_s, fleet_cap=fleet_cap)
        handle._enqueued_at = time.monotonic()
        with self._cv:
            if self._closing:
                raise RuntimeError("session is closed")
            self._queue.append(handle)
            self._handles.append(handle)
            self._ensure_workers_locked()
            self._cv.notify_all()
        return handle

    def sql(self, text: str, timeout: float | None = None) -> QueryResult:
        """Submit and block for the result (single-query convenience)."""
        return self.submit(text).result(timeout)

    def explain(self, text: str) -> str:
        """Compile ``text`` and describe its physical plan (no workers
        are invoked)."""
        if self.catalog is None:
            raise RuntimeError("no catalog attached — call "
                               "attach_catalog() or ensure_tpch() first")
        return QueryHandle("explain", text, self).explain()

    # -- scheduler -----------------------------------------------------------
    def pause(self) -> None:
        """Stop admitting queued queries (already-running ones finish).
        Lets clients build a batch, reorder, or cancel before any worker
        is invoked."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def drain(self) -> None:
        """Block until every submitted query reached a terminal state."""
        for h in list(self._handles):
            h.wait()

    def close(self, *, cancel_pending: bool = False) -> None:
        """Finish (or cancel) outstanding queries and stop the workers."""
        if cancel_pending:
            for h in list(self._handles):
                h.cancel()
        with self._cv:
            self._closing = True
            self._paused = False
            self._cv.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join()
        if self._owns_platform:
            self.platform.close()

    def __enter__(self) -> "SkyriseSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- session-level introspection ----------------------------------------
    def stats(self) -> dict:
        """Aggregate session statistics (shared-infrastructure view)."""
        adm = self.platform.admission
        states = [h.state for h in self._handles]
        return {
            "queries_submitted": len(self._handles),
            "queries_by_state": {
                s.value: sum(1 for x in states if x is s)
                for s in QueryState if any(x is s for x in states)},
            "platform_invocations": self.platform.invocations,
            "platform_cold_starts": self.platform.cold_starts,
            "quota": adm.quota,
            "max_workers_in_flight": adm.max_in_flight,
            "registry_claims": self.registry.claims,
            "inflight_dedup_hits": self.registry.dedup_hits,
            "store_cost_cents": self.store.stats.cost_cents,
            "footer_cache_hits": self.footer_cache.hits,
            "footer_cache_entries": len(self.footer_cache),
            "adaptations": self._count_adaptations(),
            "exchange_strategies": self._count_exchange_strategies(),
            "calibrated_predicates": len(self.store.list("calibration/")),
        }

    def _count_adaptations(self) -> int:
        """Barrier re-optimizations applied across completed queries."""
        n = 0
        for h in self._handles:
            with h._lock:
                result = h._result
            if result is not None:
                n += sum(len(p.adaptations) for p in result.stats.pipelines)
        return n

    def _count_exchange_strategies(self) -> dict[str, int]:
        """Executed hash exchanges per shuffle strategy (exec.exchange)."""
        out: dict[str, int] = {}
        for h in self._handles:
            with h._lock:
                result = h._result
            if result is None:
                continue
            for p in result.stats.pipelines:
                if p.exchange_strategy and not p.cache_hit:
                    out[p.exchange_strategy] = \
                        out.get(p.exchange_strategy, 0) + 1
        return out

    def add_observer(self, observer: QueryObserver) -> None:
        self.observers.add(observer)

    # -- internals -----------------------------------------------------------
    def _engine(self, handle: QueryHandle,
                query_span: int | None = None) -> QueryEngine:
        return QueryEngine(
            self.store, self.catalog, platform=self.platform,
            config=self.config, cost_model=self.cost_model,
            registry=self.registry, handler=self.handler,
            observer=self.observers, query_id=handle.query_id,
            cancel_check=handle._raise_if_cancelled,
            priority=handle.priority, tenant=handle.tenant,
            deadline_s=handle.deadline_s, fleet_cap=handle.fleet_cap,
            query_span=query_span)

    def _plan_for(self, handle: QueryHandle,
                  query_span: int | None = None):
        """Plan (but do not execute) a handle's query, caching the plan
        on the handle so the scheduler reuses it; a traced run's planning
        is a ``query.plan`` span under ``query_span``."""
        with handle._lock:
            plan = handle._plan
        if plan is None:
            t0 = time.perf_counter_ns() if query_span is not None else 0
            plan = self._engine(handle).plan_sql(handle.sql)
            if query_span is not None:
                emit_span(self.observers, handle.query_id, "query.plan",
                          t0, query_span)
            with handle._lock:
                handle._plan = plan
        return plan

    def _display_plan(self, handle: QueryHandle):
        """The *compile-time* plan for EXPLAIN. Once execution begins,
        the engine adapts the cached plan's params in place at stage
        barriers, so a fresh compile is needed to show the planner's
        choices (explain_analyze renders planned vs adapted instead)."""
        with handle._lock:
            state = handle._state
        if state is QueryState.QUEUED:
            return self._plan_for(handle)
        return self._engine(handle).plan_sql(handle.sql)

    def _notify_state(self, handle: QueryHandle, state: QueryState) -> None:
        self.observers.on_query_state(handle.query_id, state.value)

    def _ensure_workers_locked(self) -> None:
        want = min(self.max_concurrent_queries, len(self._queue))
        idle = len(self._threads) - self._active
        for _ in range(max(0, want - idle)):
            if len(self._threads) >= self.max_concurrent_queries:
                break
            t = threading.Thread(
                target=self._worker_loop,
                name=f"skyrise-s{self._sid}-w{len(self._threads)}",
                daemon=True)
            self._threads.append(t)
            t.start()

    def _pop_next_locked(self) -> QueryHandle:
        """Highest effective priority first (priority + aging bump),
        ties in submission order — mirrors the admission ledger, whose
        (configurable) aging interval it shares."""
        now = time.monotonic()
        aging_s = self.platform.admission.aging_interval_s

        def eff(h: QueryHandle) -> float:
            return h.priority + (now - getattr(h, "_enqueued_at", now)) \
                / aging_s

        best = max(range(len(self._queue)),
                   key=lambda i: (eff(self._queue[i]), -i))
        handle = self._queue[best]
        del self._queue[best]
        return handle

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._closing and (self._paused
                                             or not self._queue):
                    self._cv.wait()
                if self._closing and not self._queue:
                    return
                handle = self._pop_next_locked()
                self._active += 1
            try:
                self._run(handle)
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    def _run(self, handle: QueryHandle) -> None:
        if not handle._begin(QueryState.PLANNING):
            return  # cancelled while queued: no worker was ever invoked
        span = new_span_id() if self.observers.wants_spans else None
        t0 = time.perf_counter_ns() if span is not None else 0
        engine = self._engine(handle, span)
        try:
            plan = self._plan_for(handle, span)
            if not handle._begin(QueryState.RUNNING):
                return
            handle._finish(engine.execute_plan(plan))
        except QueryCancelled:
            handle._finish_cancelled()
        except BaseException as e:  # noqa: BLE001 - surfaced via result()
            handle._fail(e)
        finally:
            if span is not None:
                emit_span(self.observers, handle.query_id, "query", t0,
                          span_id=span)


def connect(store: ObjectStore | None = None,
            catalog: Catalog | None = None, **kwargs) -> SkyriseSession:
    """Open a :class:`SkyriseSession` — the Skyrise client entry point.

    Accepts either pre-built components (``store``, ``catalog``,
    ``platform``) or the knobs to build them (``store_dir``, ``tier``,
    ``quota``, ``faults``, ``seed``); see :class:`SkyriseSession`.
    ``device`` (default: the CUDA card) is where fragments run; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    """
    return SkyriseSession(store, catalog, **kwargs)
