"""The service client: each query through ``QueryService.submit`` and
``ServiceHandle.result``.

The service runs over one session opened as the direct client opens
it, with the configuration's tenants (``TenantConfig`` fields; none:
every request as the service's one unnamed tenant) and dispatcher poll,
and its request ledger on the store's KV tier with the configuration's
namespace and lease.
"""

from __future__ import annotations

import threading

from skybench.clients.session import connect

# a request that has not answered after this long has failed
RESULT_TIMEOUT_S = 600.0


class Client:
    def __init__(self, cfg: dict, store, catalog, device, observer):
        from repro_torch.service import (QueryService, RequestLedger,
                                         TenantConfig)
        svc = cfg["service"]
        self.store = store
        self.session = connect(cfg, store, catalog, device, observer)
        self.service = QueryService(
            self.session,
            tenants=tuple(TenantConfig(**t) for t in svc["tenants"]),
            ledger=RequestLedger(store, namespace=svc["ledger_namespace"],
                                 lease_ttl_s=svc["lease_ttl_s"]),
            poll_interval_s=svc["poll_interval_s"])
        self._ids: list[str] = []
        self._lock = threading.Lock()

    def run(self, text: str) -> tuple[dict, str]:
        """The request's rows, as its client receives them, and its id."""
        handle = self.service.submit(text)
        with self._lock:
            self._ids.append(handle.request_id)
        return (handle.result(RESULT_TIMEOUT_S).fetch(self.store),
                handle.request_id)

    def acknowledged(self) -> list[dict]:
        """Every request the service acknowledged, as its ledger reads
        back now: its final status and its timestamps."""
        with self._lock:
            ids = list(self._ids)
        out = []
        for rid in ids:
            e = self.service.ledger.get(rid)
            out.append({"request_id": rid,
                        "status": None if e is None else e.status.value,
                        "submitted_at": None if e is None
                        else e.submitted_at,
                        "started_at": None if e is None else e.started_at,
                        "finished_at": None if e is None
                        else e.finished_at})
        return out

    def close(self) -> None:
        self.service.close()
        self.session.close()
