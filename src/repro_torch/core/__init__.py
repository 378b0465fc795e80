"""The paper's primary contribution: the fully serverless query-processing
runtime — per-query execution engine, FaaS platform model with cross-query
admission control, adaptive straggler re-triggering, failure taxonomy with
stage-checkpoint restart, semantic result cache, elastic worker sizing,
and the end-to-end cost model.

The public client entry point is :mod:`repro_torch.api` (``connect()`` →
``SkyriseSession``); this package holds the engine underneath it.
"""

from repro_torch.core.adaptive import Reoptimizer
from repro_torch.core.chaos import ChaosConfig, ChaosEngine, ChaosKill
from repro_torch.core.coordinator import QueryCoordinator
from repro_torch.core.cost import CostBreakdown, CostModel
from repro_torch.core.engine import (CoordinatorConfig, PipelineReport,
                               QueryAborted, QueryCancelled, QueryEngine,
                               QueryResult, QueryStats, explain_analyze,
                               explain_plan)
from repro_torch.core.events import ConsoleObserver, ObserverMux, QueryObserver
from repro_torch.core.platform import (AdmissionController, FaasPlatform,
                                 FaultPlan)
from repro_torch.core.registry import ResultRegistry
from repro_torch.core.retry import (QueryFailedError, RetryBudgetExhausted,
                              RetryPolicy, TransientInfraError)

__all__ = [
    "AdmissionController", "ChaosConfig", "ChaosEngine", "ChaosKill",
    "ConsoleObserver", "CoordinatorConfig", "CostBreakdown", "CostModel",
    "FaasPlatform", "FaultPlan", "ObserverMux", "PipelineReport",
    "QueryAborted", "QueryCancelled", "QueryCoordinator", "QueryEngine",
    "QueryFailedError", "QueryObserver", "QueryResult", "QueryStats",
    "Reoptimizer", "ResultRegistry", "RetryBudgetExhausted", "RetryPolicy",
    "TransientInfraError", "explain_analyze", "explain_plan",
]
