"""Query handles: the client-side view of one submitted query.

A handle is returned immediately by ``SkyriseSession.submit`` and tracks
the query through an explicit lifecycle::

    QUEUED → PLANNING → RUNNING → SUCCEEDED | FAILED | CANCELLED

``result()`` blocks for the terminal state; ``cancel()`` is guaranteed
never to invoke a worker when the query is still queued, and takes
effect at the next pipeline/wave boundary when it is already running.
"""

from __future__ import annotations

import enum
import threading

from repro_torch.core.engine import QueryCancelled, QueryResult, QueryStats
from repro_torch.core.retry import QueryFailedError


class QueryState(enum.Enum):
    QUEUED = "QUEUED"
    PLANNING = "PLANNING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    @property
    def terminal(self) -> bool:
        return self in (QueryState.SUCCEEDED, QueryState.FAILED,
                        QueryState.CANCELLED)


class QueryHandle:
    """Lifecycle, result, and stats of one query in a session."""

    def __init__(self, query_id: str, sql: str, session,
                 priority: int = 0, tenant: str | None = None,
                 deadline_s: float | None = None,
                 fleet_cap: int | None = None):
        self.query_id = query_id
        self.sql = sql
        self.priority = priority
        # service-tier attributes (repro_torch.service): fair-share admission
        # group, SLO deadline (simulated seconds), degraded-fleet clamp
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.fleet_cap = fleet_cap
        self._session = session
        # RLock: state transitions notify observers while holding the
        # lock, and observers may read handle.state back.
        self._lock = threading.RLock()
        self._done = threading.Event()
        self._state = QueryState.QUEUED
        self._cancel_requested = False
        self._result: QueryResult | None = None
        self._error: BaseException | None = None
        self._plan = None

    def __repr__(self) -> str:
        return f"<QueryHandle {self.query_id} {self._state.value}>"

    # -- client API ----------------------------------------------------------
    @property
    def state(self) -> QueryState:
        with self._lock:
            return self._state

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until terminal; True if the query reached a terminal
        state within ``timeout``."""
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> QueryResult:
        """Block for the QueryResult; raises on FAILED/CANCELLED.

        Failures surface through the typed taxonomy (``core.retry``):
        an already-typed error — :class:`QueryAborted`,
        :class:`RetryBudgetExhausted`, any :class:`QueryFailedError` —
        is re-raised as-is; anything else is wrapped in a
        :class:`QueryFailedError` with the original exception chained
        (``__cause__``), so the causal chain from the failing fragment
        is preserved either way."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} still {self.state.value} "
                f"after {timeout}s")
        with self._lock:
            if self._state is QueryState.CANCELLED:
                raise QueryCancelled(f"query {self.query_id} was cancelled")
            if self._error is not None:
                if isinstance(self._error, QueryFailedError):
                    raise self._error
                raise QueryFailedError(
                    f"query {self.query_id} failed: "
                    f"{self._error}") from self._error
            assert self._result is not None
            return self._result

    def fetch(self, timeout: float | None = None):
        """Shorthand: block for the result and read its columns."""
        return self.result(timeout).fetch(self._session.store)

    def stats(self, timeout: float | None = None) -> QueryStats:
        """Execution statistics of the completed query (blocks)."""
        return self.result(timeout).stats

    def explain(self) -> str:
        """Compile-time physical plan description; plans the query if
        still queued (planning is pure — no workers are invoked)."""
        from repro_torch.core.engine import explain_plan
        return explain_plan(self._session._display_plan(self))

    def explain_analyze(self, timeout: float | None = None) -> str:
        """EXPLAIN ANALYZE: blocks for the result, then renders the plan
        annotated with observed execution — est vs actual rows, planned
        vs invoked fleets, and the barrier adaptations applied."""
        from repro_torch.core.engine import explain_analyze
        res = self.result(timeout)
        with self._lock:
            plan = self._plan
        return explain_analyze(plan, res.stats)

    def error(self) -> BaseException | None:
        """The failure cause once FAILED (None otherwise)."""
        with self._lock:
            return self._error

    def cancel(self) -> bool:
        """Request cancellation. Returns True if the query will not (or
        did not) produce a result: queued queries are cancelled before
        any worker is invoked; running queries stop at the next
        pipeline/wave boundary. False if already finished."""
        with self._lock:
            if self._state.terminal:
                return self._state is QueryState.CANCELLED
            self._cancel_requested = True
            if self._state is QueryState.QUEUED:
                self._transition_locked(QueryState.CANCELLED)
            return True

    # -- scheduler-side transitions -----------------------------------------
    def _transition_locked(self, state: QueryState) -> None:
        self._state = state
        if state.terminal:
            self._done.set()
        self._session._notify_state(self, state)

    def _begin(self, state: QueryState) -> bool:
        """QUEUED → PLANNING (or RUNNING); False if cancelled meanwhile."""
        with self._lock:
            if self._state.terminal:
                return False
            if self._cancel_requested:
                self._transition_locked(QueryState.CANCELLED)
                return False
            self._transition_locked(state)
            return True

    def _raise_if_cancelled(self) -> None:
        """Engine cancel_check hook (called at pipeline/wave boundaries)."""
        with self._lock:
            if self._cancel_requested:
                raise QueryCancelled(self.query_id)

    def _finish(self, result: QueryResult) -> None:
        with self._lock:
            self._result = result
            self._transition_locked(QueryState.SUCCEEDED)

    def _finish_cancelled(self) -> None:
        with self._lock:
            self._transition_locked(QueryState.CANCELLED)

    def _fail(self, error: BaseException) -> None:
        with self._lock:
            self._error = error
            self._transition_locked(QueryState.FAILED)
