"""Skyrise public client API.

Everything a client needs is here::

    from repro_torch.api import connect

    session = connect(quota=128)          # shared platform + store + cache
    session.ensure_tpch(sf=0.01)

    res = session.sql("select count(*) as n from lineitem")   # blocking
    handle = session.submit(TPCH_Q12)                         # concurrent
    print(handle.explain())
    cols = handle.result().fetch(session.store)
    print(handle.stats().cost.total_cents)

Sessions multiplex concurrently submitted queries over one
``FaasPlatform`` concurrency quota (wave-based admission spanning
queries), one worker handler, and one semantic result cache — the
multi-tenant layer the paper's single-query coordinator deliberately
leaves out (section 3.1).
"""

from repro_torch.core.chaos import ChaosConfig, ChaosEngine
from repro_torch.core.engine import (CoordinatorConfig, QueryAborted,
                               QueryCancelled, QueryResult, QueryStats,
                               explain_analyze, explain_plan)
from repro_torch.core.events import ConsoleObserver, QueryObserver
from repro_torch.core.platform import FaasPlatform, FaultPlan
from repro_torch.core.retry import (QueryFailedError, RetryBudgetExhausted,
                              RetryPolicy, TransientInfraError)

from repro_torch.api.handle import QueryHandle, QueryState
from repro_torch.api.session import SkyriseSession, connect

__all__ = [
    "ChaosConfig", "ChaosEngine", "ConsoleObserver", "CoordinatorConfig",
    "FaasPlatform", "FaultPlan", "QueryAborted", "QueryCancelled",
    "QueryFailedError", "QueryHandle", "QueryObserver", "QueryResult",
    "QueryState", "QueryStats", "RetryBudgetExhausted", "RetryPolicy",
    "SkyriseSession", "TransientInfraError", "connect", "explain_analyze",
    "explain_plan",
]
