"""Execution observers: structured event hooks replacing ad-hoc prints.

The per-query engine emits lifecycle and adaptive-behavior events; a
session multiplexes them to any number of registered observers. Override
only the hooks you need — every method is a no-op by default, and
observer exceptions never fail a query.

Spans: an observer that overrides ``on_span`` turns tracing on for the
session it is added to. Each span site then reads
``time.perf_counter_ns()`` (the clock ``time.perf_counter`` reads too)
at its two ends; with no such observer a site costs a boolean test and
reads no clock.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

_span_ids = itertools.count(1)


def new_span_id() -> int:
    """A span id unique in the process."""
    return next(_span_ids)


@dataclasses.dataclass(slots=True)
class Span:
    """One timed interval of a query's execution, on the host clock."""
    id: int
    parent: int | None
    query_id: str
    name: str
    t0_ns: int
    t1_ns: int
    thread: str
    attrs: dict


def emit_span(observer: "QueryObserver", query_id: str, name: str,
              t0_ns: int, parent: int | None = None,
              span_id: int | None = None, **attrs) -> None:
    """Send ``observer`` the span ``name`` of this thread that began at
    ``t0_ns`` and ends now."""
    observer.on_span(Span(span_id or new_span_id(), parent, query_id, name,
                          t0_ns, time.perf_counter_ns(),
                          threading.current_thread().name, attrs))


class QueryObserver:
    """Base class: subclass and override the events you care about.

    Concurrency contract: fragments execute wall-clock-parallel, so
    ``on_retry`` (and hooks of different queries in one session) may
    fire concurrently from worker threads — observers that mutate
    shared state must synchronize it themselves.
    """

    def on_query_state(self, query_id: str, state: str) -> None:
        """Lifecycle transition (QUEUED/PLANNING/RUNNING/...)."""

    def on_pipeline_start(self, query_id: str, pid: int, sem_hash: str,
                          n_fragments: int) -> None:
        """A pipeline was scheduled (not a cache hit)."""

    def on_pipeline_complete(self, query_id: str, report) -> None:
        """A pipeline finished; ``report`` is a PipelineReport
        (``report.cache_hit`` distinguishes cache skips)."""

    def on_straggler(self, query_id: str, pid: int, fragment: int) -> None:
        """A straggling worker was detected and re-triggered."""

    def on_retry(self, query_id: str, pid: int, fragment: int,
                 attempt: int) -> None:
        """A failed fragment is being retried (transient failure)."""

    def on_adaptation(self, query_id: str, pid: int,
                      adaptation: dict) -> None:
        """A barrier re-optimization was applied to a pipeline before
        launch (fleet_resize / partition_prune / broadcast_downgrade /
        exchange_retier — see ``repro_torch.core.adaptive``)."""

    def on_span(self, span: Span) -> None:
        """A span ended. Overriding this turns tracing on; it may fire
        from any thread of the session."""


def wants_spans(observer: QueryObserver) -> bool:
    """Whether ``observer`` takes spans: it overrides ``on_span`` (a mux:
    one of its observers does)."""
    if isinstance(observer, ObserverMux):
        return observer.wants_spans
    return type(observer).on_span is not QueryObserver.on_span


class ObserverMux(QueryObserver):
    """Fans events out to many observers; isolates their failures."""

    def __init__(self, observers: list[QueryObserver] | None = None):
        self.observers: list[QueryObserver] = list(observers or [])
        self.wants_spans = any(map(wants_spans, self.observers))

    def add(self, observer: QueryObserver) -> None:
        self.observers.append(observer)
        self.wants_spans = self.wants_spans or wants_spans(observer)

    def _emit(self, method: str, *args) -> None:
        for obs in self.observers:
            try:
                getattr(obs, method)(*args)
            except Exception:  # noqa: BLE001 - observers must not kill queries
                pass

    def on_query_state(self, query_id, state):
        self._emit("on_query_state", query_id, state)

    def on_pipeline_start(self, query_id, pid, sem_hash, n_fragments):
        self._emit("on_pipeline_start", query_id, pid, sem_hash,
                   n_fragments)

    def on_pipeline_complete(self, query_id, report):
        self._emit("on_pipeline_complete", query_id, report)

    def on_straggler(self, query_id, pid, fragment):
        self._emit("on_straggler", query_id, pid, fragment)

    def on_retry(self, query_id, pid, fragment, attempt):
        self._emit("on_retry", query_id, pid, fragment, attempt)

    def on_adaptation(self, query_id, pid, adaptation):
        self._emit("on_adaptation", query_id, pid, adaptation)

    def on_span(self, span):
        self._emit("on_span", span)


class ConsoleObserver(QueryObserver):
    """Prints a compact execution trace (the old ad-hoc prints, unified)."""

    def __init__(self, out=None):
        import sys
        self.out = out or sys.stderr

    def _p(self, msg: str) -> None:
        print(msg, file=self.out, flush=True)

    def on_query_state(self, query_id, state):
        self._p(f"[{query_id}] {state}")

    def on_pipeline_start(self, query_id, pid, sem_hash, n_fragments):
        self._p(f"[{query_id}] pipeline {pid} ({sem_hash[:8]}) → "
                f"{n_fragments} workers")

    def on_pipeline_complete(self, query_id, report):
        if report.deduped:
            tag = "shared in-flight execution"
        elif report.cache_hit:
            tag = "cache hit"
        else:
            tag = f"{report.attempts} attempts, {report.sim_s:.2f}s sim"
        self._p(f"[{query_id}] pipeline {report.pid} done ({tag})")

    def on_straggler(self, query_id, pid, fragment):
        self._p(f"[{query_id}] straggler re-triggered: "
                f"pipeline {pid} fragment {fragment}")

    def on_retry(self, query_id, pid, fragment, attempt):
        self._p(f"[{query_id}] retry: pipeline {pid} fragment {fragment} "
                f"attempt {attempt}")

    def on_adaptation(self, query_id, pid, adaptation):
        self._p(f"[{query_id}] adapt: pipeline {pid} "
                f"{adaptation.get('kind')} {adaptation}")
