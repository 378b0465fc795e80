"""Skyrise query *service* tier.

Layers a durable, multi-tenant, SLO-aware front end over the session /
engine stack: request ledger on the KV tier (``ledger``), weighted
fair-share admission with cost budgets (``admission``), multi-query DAG
scheduling (``dag``), and the orchestrating ``QueryService``
(``service``).
"""

from repro_torch.service.admission import FairShareAdmission, TenantConfig
from repro_torch.service.dag import topological_order, validate_dag
from repro_torch.service.ledger import (LedgerConflict, LedgerEntry,
                                        RequestLedger, RequestStatus)
from repro_torch.service.service import (QueryService, RequestFailed,
                                         ServiceHandle, ServiceResult)

__all__ = [
    "FairShareAdmission", "TenantConfig",
    "topological_order", "validate_dag",
    "LedgerConflict", "LedgerEntry", "RequestLedger", "RequestStatus",
    "QueryService", "RequestFailed", "ServiceHandle", "ServiceResult",
]
