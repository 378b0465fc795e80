"""Deprecated single-query coordinator facade.

The execution machinery lives in :mod:`repro_torch.core.engine`
(``QueryEngine``); multi-query sessions live in :mod:`repro_torch.api`
(``connect`` / ``SkyriseSession``). ``QueryCoordinator`` remains as a
thin shim so pre-session call sites keep working:

    coord = QueryCoordinator(store, catalog, platform=platform)
    res = coord.execute_sql("select ...")

New code should use the session API instead::

    from repro_torch.api import connect
    session = connect(store=store, catalog=catalog, platform=platform)
    res = session.sql("select ...")
"""

from __future__ import annotations

import warnings

# Re-exported for backward compatibility: these names historically lived
# in this module.
from repro_torch.core.engine import (CoordinatorConfig, PipelineReport,  # noqa: F401
                               QueryAborted, QueryEngine, QueryResult,
                               QueryStats)


class QueryCoordinator(QueryEngine):
    """Deprecated alias for :class:`repro_torch.core.engine.QueryEngine`.

    Each instance owns a private registry handle and worker handler bound
    to ``store`` (the historical behavior); the semantic result cache is
    still shared across coordinators through the store itself.
    """

    def __init__(self, store, catalog, *, platform=None, config=None,
                 cost_model=None):
        warnings.warn(
            "QueryCoordinator is deprecated; use repro_torch.api.connect() — "
            "a SkyriseSession shares one platform quota, worker handler, "
            "and result cache across concurrent queries",
            DeprecationWarning, stacklevel=2)
        super().__init__(store, catalog, platform=platform, config=config,
                         cost_model=cost_model)
