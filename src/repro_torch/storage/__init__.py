"""Storage management layer: object store, tiers, PAX format, I/O handlers."""

from repro_torch.storage.io_handlers import (FooterCache, InputHandler, IoStats,
                                       OutputHandler)
from repro_torch.storage.object_store import (FilesystemBackend, MemoryBackend,
                                        ObjectStore, StoreStats)
from repro_torch.storage.pax import (ColumnSpec, PaxFooter, ZonePredicate,
                               coalesce_ranges, parse_footer,
                               plan_chunk_requests, surviving_row_groups,
                               write_pax)
from repro_torch.storage.tiers import TIERS, StorageTier

__all__ = [
    "ColumnSpec", "FilesystemBackend", "FooterCache", "InputHandler",
    "IoStats", "MemoryBackend", "ObjectStore", "OutputHandler", "PaxFooter",
    "StorageTier", "StoreStats", "TIERS", "ZonePredicate",
    "coalesce_ranges", "parse_footer", "plan_chunk_requests",
    "surviving_row_groups", "write_pax",
]
