"""The query service: durable, multi-tenant front end of a session.

``QueryService`` wraps a ``SkyriseSession`` with the pieces a *shared*
serverless SQL endpoint needs:

  * every request is persisted in the KV-tier request ledger before
    anything runs — the service process is stateless and restartable;
  * a dispatcher thread admits QUEUED requests when their tenant is
    within budget and their DAG dependencies SUCCEEDED, claims them
    under this instance's ownership lease, and hands them to the
    session scheduler (fair share is enforced per *fragment slot* by
    the platform's admission ledger, so it holds across queries of any
    shape);
  * SLO deadlines ride the request into the engine: the remaining
    deadline becomes per-stage latency budgets for cost-optimal fleet
    sizing, escalating at barriers when the query runs behind — and
    they order the queue itself (``deadline_order``): tightest
    *feasible* deadline first, judged against the tenant's
    observed-runtime EMA, so an already-lost SLO never displaces a
    winnable one;
  * on completion the result pointer (object locations + cost) is
    written back to the ledger and the tenant's budget is charged;
    over-budget tenants degrade to their minimum fleet, then throttle
    until the window rolls over;
  * a second (or restarted) instance recovers: expired leases re-queue
    orphaned ADMITTED/RUNNING entries, and re-execution is deduped
    against already-published pipeline results by the semantic-hash
    registry — the fleet runs at most once per pipeline.

Service handles resolve through the ledger's *watch* primitive (the
same store-level notification seam the registry waiters use), so a
client can await a request submitted by a different process.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np

from repro_torch.api.session import SkyriseSession
from repro_torch.core.engine import QueryCancelled
from repro_torch.service.admission import (FairShareAdmission,
                                           TenantConfig, deadline_order)
from repro_torch.service.dag import validate_dag
from repro_torch.service.ledger import (LedgerConflict, LedgerEntry,
                                        RequestLedger, RequestStatus)
from repro_torch.storage.io_handlers import InputHandler
from repro_torch.storage.object_store import ObjectStore


class RequestFailed(RuntimeError):
    """The service recorded the request as FAILED."""


class ServiceResult:
    """Client-side view of a SUCCEEDED ledger entry's result pointer."""

    def __init__(self, entry: LedgerEntry):
        self.entry = entry
        pointer = entry.result or {}
        self.locations: list[str] = list(pointer.get("locations", ()))
        self.output_names: list[str] = list(
            pointer.get("output_names", ()))
        self.cost_cents: float = pointer.get("cost_cents", 0.0)
        self.sim_latency_s: float = pointer.get("sim_latency_s", 0.0)
        self.cache_hits: int = pointer.get("cache_hits", 0)
        self.deadline_missed: bool = pointer.get("deadline_missed", False)
        self.pipelined_pipelines: int = pointer.get(
            "pipelined_pipelines", 0)
        self.overlap_saved_s: float = pointer.get("overlap_saved_s", 0.0)

    def fetch(self, store: ObjectStore) -> dict[str, np.ndarray]:
        ih = InputHandler(store)
        parts = [ih.read_table(loc)[0] for loc in self.locations]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}


class ServiceHandle:
    """Durable request handle: resolves through the ledger, so it works
    across service restarts and even from a different process."""

    def __init__(self, request_id: str, service: "QueryService"):
        self.request_id = request_id
        self._service = service

    def __repr__(self) -> str:
        return f"<ServiceHandle {self.request_id} {self.status().value}>"

    def entry(self) -> LedgerEntry:
        entry = self._service.ledger.get(self.request_id)
        if entry is None:
            raise KeyError(f"request {self.request_id} not in ledger")
        return entry

    def status(self) -> RequestStatus:
        return self.entry().status

    def wait(self, timeout: float | None = None) -> LedgerEntry:
        """Block (via ledger watch) until the request is terminal."""
        ledger = self._service.ledger
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            token = ledger.version_token(self.request_id)
            entry = self.entry()
            if entry.status.terminal:
                return entry
            left = None if deadline is None \
                else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(
                    f"request {self.request_id} still "
                    f"{entry.status.value} after {timeout}s")
            # bounded watch: lease expiry / re-queue also changes the
            # record, so progress (or recovery) always wakes us
            ledger.watch(self.request_id, token,
                         timeout_s=1.0 if left is None
                         else min(left, 1.0))

    def result(self, timeout: float | None = None) -> ServiceResult:
        entry = self.wait(timeout)
        if entry.status is RequestStatus.SUCCEEDED:
            return ServiceResult(entry)
        if entry.status is RequestStatus.CANCELLED:
            raise QueryCancelled(f"request {self.request_id} cancelled")
        raise RequestFailed(
            f"request {self.request_id} failed: {entry.error}")

    def fetch(self, timeout: float | None = None):
        return self.result(timeout).fetch(self._service.session.store)

    def cancel(self) -> bool:
        return self._service.cancel(self.request_id)


class QueryService:
    """Durable multi-tenant query endpoint over one session."""

    def __init__(self, session: SkyriseSession, *,
                 tenants: tuple[TenantConfig, ...] = (),
                 ledger: RequestLedger | None = None,
                 lease_ttl_s: float = 30.0,
                 service_id: str | None = None,
                 poll_interval_s: float = 0.02,
                 start: bool = True):
        self.session = session
        self.ledger = ledger if ledger is not None else RequestLedger(
            session.store, lease_ttl_s=lease_ttl_s)
        self.admission = FairShareAdmission(session.platform.admission,
                                            tuple(tenants))
        self.service_id = service_id or f"svc-{uuid.uuid4().hex[:8]}"
        self._lock = threading.Lock()
        self._running: dict[str, object] = {}   # rid → session handle
        self._closing = threading.Event()
        self._thread: threading.Thread | None = None
        self.deadline_misses = 0
        self.recovered_requests = 0
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Recover orphaned ledger entries, then start dispatching."""
        if self._thread is not None:
            return
        self.recovered_requests += len(self.ledger.recover_expired())
        self._closing.clear()
        self._thread = threading.Thread(
            target=self._dispatch_loop,
            name=f"skyrise-{self.service_id}", daemon=True)
        self._thread.start()

    def close(self, *, drain: bool = True) -> None:
        """Graceful shutdown: optionally wait for owned requests to
        finish (and write their terminal records) before stopping."""
        if drain:
            self.drain()
        self.kill()

    def kill(self) -> None:
        """Abrupt stop — the process-death analog used by the recovery
        tests: the dispatcher halts, owned ADMITTED/RUNNING ledger
        entries are left to expire their leases. Queries already handed
        to the session keep running (their published pipeline results
        are what makes recovery duplicate-free)."""
        self._closing.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every request this instance owns is terminal."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            with self._lock:
                busy = bool(self._running)
            if not busy:
                # QUEUED entries this instance could still admit
                queued = self.ledger.entries(
                    status=RequestStatus.QUEUED)
                if not queued or self._thread is None:
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("service drain timed out")
            time.sleep(0.01)

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client API ----------------------------------------------------------
    def submit(self, sql: str, *, tenant: str | None = None,
               priority: int | None = None,
               deadline_s: float | None = None,
               request_id: str | None = None,
               dag_id: str | None = None,
               depends_on: list[str] | None = None) -> ServiceHandle:
        """Persist a request and return its durable handle. Tenant
        defaults (priority, deadline) fill unspecified fields."""
        cfg = self.admission.config(tenant)
        if priority is None:
            priority = cfg.priority if cfg else 0
        if deadline_s is None and cfg is not None:
            deadline_s = cfg.deadline_s
        entry = self.ledger.submit(
            sql, tenant=tenant, priority=priority, deadline_s=deadline_s,
            request_id=request_id, dag_id=dag_id, depends_on=depends_on)
        return ServiceHandle(entry.request_id, self)

    def submit_dag(self, statements: list[str],
                   depends_on: dict[int, list[int]] | None = None, *,
                   tenant: str | None = None,
                   priority: int | None = None,
                   deadline_s: float | None = None) -> list[ServiceHandle]:
        """Submit a DAG of queries; node i waits for ``depends_on[i]``.

        Ordering is all an edge buys — *data* sharing is automatic:
        nodes containing the same subplan share one materialization
        through the semantic-hash registry, edges or not.
        """
        depends_on = depends_on or {}
        validate_dag(len(statements), depends_on)
        dag_id = f"dag-{uuid.uuid4().hex[:8]}"
        rids = [f"{dag_id}-n{i}" for i in range(len(statements))]
        return [self.submit(sql, tenant=tenant, priority=priority,
                            deadline_s=deadline_s, request_id=rids[i],
                            dag_id=dag_id,
                            depends_on=[rids[d] for d in
                                        depends_on.get(i, ())])
                for i, sql in enumerate(statements)]

    def cancel(self, request_id: str) -> bool:
        """Cancel a request: QUEUED entries terminate immediately;
        RUNNING ones owned here are cancelled at the next boundary."""
        entry = self.ledger.get(request_id)
        if entry is None or entry.status.terminal:
            return entry is not None \
                and entry.status is RequestStatus.CANCELLED
        if entry.status is RequestStatus.QUEUED:
            try:
                self.ledger.transition(request_id,
                                       RequestStatus.CANCELLED,
                                       expected_version=entry.version)
                return True
            except LedgerConflict:
                return self.cancel(request_id)    # raced: re-read
        with self._lock:
            handle = self._running.get(request_id)
        if handle is not None:
            handle.cancel()
            return True
        return False    # owned by another instance: its lease decides

    def stats(self) -> dict:
        by_status: dict[str, int] = {}
        for entry in self.ledger.entries():
            by_status[entry.status.value] = \
                by_status.get(entry.status.value, 0) + 1
        return {
            "service_id": self.service_id,
            "requests_by_status": by_status,
            "tenants": self.admission.stats(),
            "deadline_misses": self.deadline_misses,
            "recovered_requests": self.recovered_requests,
        }

    # -- dispatcher ----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        from repro_torch.core.chaos import ChaosKill
        poll = 0.02
        last_recover = time.monotonic()
        while not self._closing.is_set():
            try:
                self._harvest_finished()
                self._renew_leases()
                now = time.monotonic()
                if now - last_recover >= self.ledger.lease_ttl_s / 3:
                    self.recovered_requests += len(
                        self.ledger.recover_expired())
                    last_recover = now
                self._admit_queued()
            except ChaosKill:
                # instance death: the dispatcher stops cold, leaving
                # ledger entries to lease expiry — a peer (or a restart)
                # recovers them via recover_expired
                self._closing.set()
                return
            self._closing.wait(poll)

    def _admit_queued(self) -> None:
        queued = deadline_order(
            self.ledger.entries(status=RequestStatus.QUEUED),
            self.admission.runtime_estimate)
        for entry in queued:
            if self._closing.is_set():
                return
            ready, failed_dep = self._deps_state(entry)
            if failed_dep is not None:
                try:
                    self.ledger.transition(
                        entry.request_id, RequestStatus.FAILED,
                        expected_version=entry.version,
                        error=f"dependency {failed_dep} did not succeed")
                except LedgerConflict:
                    pass
                continue
            if not ready or not self.admission.admissible(entry.tenant):
                continue
            claimed = self.ledger.claim(entry.request_id,
                                        self.service_id)
            if claimed is None:
                continue    # another instance admitted it
            self._dispatch(claimed)

    def _deps_state(self, entry: LedgerEntry):
        """(all dependencies SUCCEEDED?, first dead dependency id)."""
        for rid in entry.depends_on:
            dep = self.ledger.get(rid)
            if dep is None:
                return False, rid
            if dep.status in (RequestStatus.FAILED,
                              RequestStatus.CANCELLED):
                return False, rid
            if dep.status is not RequestStatus.SUCCEEDED:
                return False, None
        return True, None

    def _dispatch(self, entry: LedgerEntry) -> None:
        cfg = self.admission.config(entry.tenant)
        fleet_cap = None
        if cfg is not None and self.admission.degraded(entry.tenant):
            fleet_cap = cfg.min_fleet
        try:
            handle = self.session.submit(
                entry.sql, priority=entry.priority, tenant=entry.tenant,
                deadline_s=entry.deadline_s, fleet_cap=fleet_cap)
        except BaseException as e:  # noqa: BLE001 - recorded, not raised
            try:
                self.ledger.transition(
                    entry.request_id, RequestStatus.FAILED,
                    if_owner=self.service_id, error=str(e))
            except LedgerConflict:
                pass
            return
        try:
            self.ledger.transition(entry.request_id,
                                   RequestStatus.RUNNING,
                                   if_owner=self.service_id)
        except LedgerConflict:
            # lease was stolen between claim and dispatch (pathological
            # TTL); the duplicate run is absorbed by the result cache
            pass
        with self._lock:
            self._running[entry.request_id] = handle

    def _renew_leases(self) -> None:
        with self._lock:
            rids = list(self._running)
        for rid in rids:
            self.ledger.renew_lease(rid, self.service_id)

    def _harvest_finished(self) -> None:
        with self._lock:
            items = list(self._running.items())
        for rid, handle in items:
            if not handle.done():
                continue
            self._record_terminal(rid, handle)
            with self._lock:
                self._running.pop(rid, None)

    def _record_terminal(self, rid: str, handle) -> None:
        entry = self.ledger.get(rid)
        if entry is None:
            return
        try:
            result = handle.result(timeout=0)
        except QueryCancelled:
            self._transition_safe(rid, RequestStatus.CANCELLED)
            return
        except BaseException as e:  # noqa: BLE001 - recorded in ledger
            self._transition_safe(rid, RequestStatus.FAILED,
                                  error=str(e))
            return
        stats = result.stats
        # the pointer goes through the ledger's msgpack codec, which takes
        # plain Python values only: a numpy or torch scalar (an np.bool_
        # from comparing np.float64s) would fail the SUCCEEDED write here
        # in the dispatcher thread, so every number is made plain
        missed = bool(entry.deadline_s is not None
                      and stats.sim_latency_s > entry.deadline_s)
        if missed:
            self.deadline_misses += 1
        self.admission.charge(entry.tenant, stats.cost.total_cents)
        self.admission.observe_runtime(entry.tenant, stats.sim_latency_s)
        self._transition_safe(rid, RequestStatus.SUCCEEDED, result={
            "locations": [str(loc) for loc in result.locations],
            "output_names": [str(n) for n in result.output_names],
            "cost_cents": float(stats.cost.total_cents),
            "sim_latency_s": float(stats.sim_latency_s),
            "cache_hits": int(stats.cache_hits),
            "deduped": sum(1 for p in stats.pipelines if p.deduped),
            "deadline_missed": missed,
            # pipelined execution telemetry: how many
            # pipelines started on partial input, and the overlap they
            # reclaimed from the simulated critical path
            "pipelined_pipelines": sum(
                1 for p in stats.pipelines if p.pipelined),
            "overlap_saved_s": float(sum(
                p.overlap_saved_s for p in stats.pipelines)),
        })

    def _transition_safe(self, rid: str, to: RequestStatus,
                         **fields) -> None:
        try:
            self.ledger.transition(rid, to, if_owner=self.service_id,
                                   **fields)
        except LedgerConflict:
            # entry was re-queued/stolen while the query ran: the other
            # instance's execution will write the terminal record; ours
            # only duplicated cached pipelines
            pass
