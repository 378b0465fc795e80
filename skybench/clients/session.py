"""The direct client: each query through ``SkyriseSession.sql``.

``repro_torch.api.connect`` opens the session over the benchmark's store
and catalog with the configuration's ``session`` settings (its limit of
queries run at once) and ``coordinator`` settings (fields of the port's
``CoordinatorConfig``); the platform's quota is the session's default.
"""

from __future__ import annotations


def connect(cfg: dict, store, catalog, device, observer):
    from repro_torch.api import connect as open_session
    from repro_torch.core import CoordinatorConfig
    return open_session(
        store=store, catalog=catalog, device=device,
        config=CoordinatorConfig(**cfg.get("coordinator", {})),
        max_concurrent_queries=cfg["session"]["max_concurrent_queries"],
        observers=(observer,))


class Client:
    """One session shared by every client of the cell."""

    def __init__(self, cfg: dict, store, catalog, device, observer):
        self.store = store
        self.session = connect(cfg, store, catalog, device, observer)

    def run(self, text: str) -> tuple[dict, None]:
        """The query's rows, as its client receives them (and no request
        id: nothing acknowledges it durably)."""
        return self.session.sql(text).fetch(self.store), None

    def acknowledged(self) -> list[dict]:
        """Requests that a durable tier acknowledged: none here."""
        return []

    def close(self) -> None:
        self.session.close()
