"""Unified retry policy and typed failure taxonomy (paper section 3.3).

Serverless infrastructure fails *routinely*: the companion measurement
study (arXiv 2501.07771) documents transient function failures, S3
throttling, and heavy first-byte tails as structural properties of FaaS
— not rare events. Skyrise's answer is a single classification every
layer shares:

  * :class:`TransientInfraError` — the infrastructure hiccuped (sandbox
    died, storage 503'd, a coordination write was lost mid-protocol).
    Retrying the *same* work is safe and expected to succeed: workers
    are idempotent single-object writers, registry/ledger protocols are
    re-entrant. Every layer retries these under one
    :class:`RetryPolicy` — bounded exponential backoff with full
    jitter — spending from one per-query :class:`RetryBudget`.
  * :class:`QueryFailedError` — the query itself is broken (bad plan,
    deterministic worker failure, exhausted retries). Never retried;
    surfaced through ``QueryHandle.result()`` with the causal chain
    from the failing fragment intact.
  * :class:`RetryBudgetExhausted` — the transient classification was
    right but the infrastructure stayed down past the budget. A
    *permanent* failure (subclass of ``QueryFailedError``) that still
    records the last transient cause.

This module is a leaf — no repro imports — so the storage, platform,
registry, ledger, and engine layers can all share it without cycles.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np


class QueryFailedError(RuntimeError):
    """Permanent query failure: retrying the same work cannot help."""


class TransientInfraError(RuntimeError):
    """Retryable infrastructure failure (sandbox death, storage 503,
    throttling, a coordination write lost mid-protocol)."""


class RetryBudgetExhausted(QueryFailedError):
    """The per-query transient-retry budget ran out: the failures were
    individually retryable, but the infrastructure stayed down.
    ``last_error`` (also chained via ``__cause__``) is the final
    transient cause."""

    def __init__(self, msg: str, *, last_error: BaseException | None = None,
                 spent: int = 0):
        super().__init__(msg)
        self.last_error = last_error
        self.spent = spent


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with *full jitter*.

    The delay before retry ``attempt`` (1-based) is drawn uniformly from
    ``[0, min(max_delay_s, base_delay_s * multiplier**(attempt-1))]`` —
    full jitter decorrelates the retry storms of a whole fleet hitting
    one throttled prefix (synchronized backoff re-creates the very
    contention it is escaping). Delays are *wall-clock* sleeps of the
    coordinator thread; they are deliberately tiny because a simulated
    platform fails instantly — against a real backend the base would be
    tens of milliseconds.

    ``budget`` bounds transient retries *per query* across every layer
    (fragment re-invokes, query-level protocol retries); ``query_retries``
    bounds how often a whole plan execution is re-driven after a
    coordinator-side transient (registry/ledger/KV chaos).
    """

    base_delay_s: float = 0.002
    max_delay_s: float = 0.05
    multiplier: float = 2.0
    budget: int = 32
    query_retries: int = 5

    def backoff_s(self, attempt: int,
                  rng: np.random.Generator | None = None) -> float:
        cap = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** max(attempt - 1, 0))
        if rng is None:
            rng = np.random.default_rng()
        return float(rng.uniform(0.0, cap))


class RetryBudget:
    """Thread-safe per-query retry allowance, spent by every layer that
    retries a transient failure (fragment re-invocation, query-level
    re-drive). Exhaustion turns the *next* transient into a permanent
    :class:`RetryBudgetExhausted`."""

    def __init__(self, budget: int):
        self.budget = max(int(budget), 0)
        self._spent = 0
        self._lock = threading.Lock()

    @property
    def spent(self) -> int:
        with self._lock:
            return self._spent

    def remaining(self) -> int:
        with self._lock:
            return self.budget - self._spent

    def try_spend(self, n: int = 1) -> bool:
        """Reserve ``n`` retries; False (nothing spent) if that would
        overdraw the budget."""
        with self._lock:
            if self._spent + n > self.budget:
                return False
            self._spent += n
            return True


def is_transient(exc: BaseException) -> bool:
    """Shared transient-vs-permanent classification: a typed transient
    that is *not* also a typed permanent failure. (``QueryFailedError``
    wins when a subclass inherits both — permanence is sticky.)"""
    return isinstance(exc, TransientInfraError) \
        and not isinstance(exc, QueryFailedError)
