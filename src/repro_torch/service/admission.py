"""Multi-tenant admission over the shared platform quota (service tier).

Three enforcement layers:

  * **fair share** — each tenant's weight is registered with the
    platform's ``AdmissionController`` (``set_share``); every fragment a
    tenant's queries invoke charges its group, and freed slots go to the
    weighted group with the largest deficit (normalized admitted work).
    This is slot-granular, so the invocation split converges to the
    weight ratio under sustained contention no matter how queries are
    shaped — extending the priority+aging scheduler, which still orders
    waiters *within* a group.

  * **cost budgets** — cents per tenant per sliding window, charged from
    each finished query's actual cost breakdown. A tenant over
    ``degrade_fraction`` of its budget is *degraded* (its queries run at
    the tenant's minimum fleet: cheapest dollars, slowest latency); a
    tenant at/over budget is *throttled* — its queued requests simply
    wait for the window to roll over, which always happens, so
    throttling is bounded, never starvation.

  * **deadline ordering** — the dispatcher admits queued requests in
    ``deadline_order``: tightest *feasible* deadline first (earliest
    deadline first, gated on the tenant's observed-runtime EMA fitting
    the deadline), then deadline-free requests FIFO, then
    infeasible-deadline requests last — a request whose SLO is already
    lost never displaces one whose SLO can still be met.

This module is pure policy on in-process state plus the platform's
admission ledger; durable request state lives in the ledger
(``repro_torch.service.ledger``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.core.platform import AdmissionController


@dataclasses.dataclass
class TenantConfig:
    """Per-tenant service policy."""

    name: str
    weight: float = 1.0                 # fair-share weight (> 0)
    priority: int = 0                   # default query priority
    budget_cents: float | None = None   # None → unmetered
    budget_window_s: float = 60.0       # wall-clock budget window
    deadline_s: float | None = None     # default SLO deadline (sim s)
    min_fleet: int = 1                  # degraded-dispatch fleet clamp
    # fraction of the budget past which dispatch degrades to min_fleet
    degrade_fraction: float = 0.8


@dataclasses.dataclass
class _TenantState:
    config: TenantConfig
    window_start: float
    spent_cents: float = 0.0
    lifetime_cents: float = 0.0
    throttled_admissions: int = 0       # admissions deferred on budget
    degraded_dispatches: int = 0
    runtime_ema_s: float | None = None  # observed sim latency (EMA)


#: EMA weight for per-tenant runtime observations — recent queries
#: dominate, so a tenant that switches workload shape re-converges in a
#: handful of queries.
RUNTIME_EMA_ALPHA = 0.3


def deadline_order(entries, runtime_estimate):
    """Admission order for QUEUED ledger entries (EDF with a
    feasibility gate):

      1. requests with a *feasible* deadline, tightest deadline first —
         feasible means the tenant's observed runtime estimate fits
         inside the deadline (no estimate yet → optimistically
         feasible);
      2. requests with no deadline, oldest submission first (plain
         FIFO — the pre-deadline behavior);
      3. requests whose deadline is *infeasible* (estimate already
         exceeds it), oldest first. They would likely miss anyway, so
         they must not displace requests whose SLO can still be met —
         but they stay in the queue and run, they are never dropped.

    ``runtime_estimate`` maps a tenant name (or None) to an estimated
    sim latency in seconds, or None when unknown."""
    def rank(e):
        if e.deadline_s is None:
            return (1, 0.0, e.submitted_at, e.request_id)
        est = runtime_estimate(e.tenant)
        if est is not None and est > e.deadline_s:
            return (2, 0.0, e.submitted_at, e.request_id)
        return (0, e.deadline_s, e.submitted_at, e.request_id)
    return sorted(entries, key=rank)


class FairShareAdmission:
    """Tenant registry + budget meter in front of the platform quota."""

    def __init__(self, admission: AdmissionController,
                 tenants: tuple[TenantConfig, ...] = ()):
        self.admission = admission
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        for cfg in tenants:
            self.register(cfg)

    def register(self, config: TenantConfig) -> None:
        with self._lock:
            self._tenants[config.name] = _TenantState(
                config, window_start=time.monotonic())
        self.admission.set_share(config.name, config.weight)

    def config(self, tenant: str | None) -> TenantConfig | None:
        with self._lock:
            st = self._tenants.get(tenant) if tenant else None
        return st.config if st else None

    # -- budget metering -----------------------------------------------------
    def _roll_window_locked(self, st: _TenantState) -> None:
        now = time.monotonic()
        if now - st.window_start >= st.config.budget_window_s:
            st.window_start = now
            st.spent_cents = 0.0

    def charge(self, tenant: str | None, cents: float) -> None:
        """Charge a finished query's actual cost to its tenant."""
        if tenant is None or cents <= 0:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            self._roll_window_locked(st)
            st.spent_cents += cents
            st.lifetime_cents += cents

    # -- runtime estimation (deadline feasibility) ----------------------------
    def observe_runtime(self, tenant: str | None, sim_s: float) -> None:
        """Fold a finished query's simulated latency into the tenant's
        runtime EMA — the feasibility estimate ``deadline_order``
        consults for its queue ordering."""
        if tenant is None or sim_s <= 0:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            if st.runtime_ema_s is None:
                st.runtime_ema_s = sim_s
            else:
                st.runtime_ema_s += RUNTIME_EMA_ALPHA * (
                    sim_s - st.runtime_ema_s)

    def runtime_estimate(self, tenant: str | None) -> float | None:
        with self._lock:
            st = self._tenants.get(tenant) if tenant else None
        return st.runtime_ema_s if st else None

    def admissible(self, tenant: str | None) -> bool:
        """May this tenant's next request be admitted *now*? False only
        while the tenant is at/over budget inside the current window —
        the window rolls over, so a throttled tenant is never starved."""
        if tenant is None:
            return True
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None or st.config.budget_cents is None:
                return True
            self._roll_window_locked(st)
            if st.spent_cents >= st.config.budget_cents:
                st.throttled_admissions += 1
                return False
            return True

    def degraded(self, tenant: str | None) -> bool:
        """Past ``degrade_fraction`` of the window budget: still
        admitted, but dispatched at the tenant's minimum fleet."""
        if tenant is None:
            return False
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None or st.config.budget_cents is None:
                return False
            self._roll_window_locked(st)
            if st.spent_cents >= \
                    st.config.degrade_fraction * st.config.budget_cents:
                st.degraded_dispatches += 1
                return True
            return False

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            tenants = {
                name: {
                    "weight": st.config.weight,
                    "budget_cents": st.config.budget_cents,
                    "window_spent_cents": st.spent_cents,
                    "lifetime_cents": st.lifetime_cents,
                    "throttled_admissions": st.throttled_admissions,
                    "degraded_dispatches": st.degraded_dispatches,
                    "runtime_ema_s": st.runtime_ema_s,
                } for name, st in self._tenants.items()}
        admitted = self.admission.admitted_by_group
        for name, t in tenants.items():
            t["admitted_slots"] = admitted.get(name, 0)
        return tenants
