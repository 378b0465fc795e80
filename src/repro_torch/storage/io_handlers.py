"""Skyrise storage I/O stack (paper section 3.4, Fig. 4).

The *input handler* splits large object reads into parallel ranged requests
aligned to the PAX layout so only relevant columns and row groups are
fetched; straggling requests are re-triggered aggressively after a short
timeout. Two request-economy optimizations sit on top (per the Lambada
observation that per-request overheads dominate serverless storage):

  * adjacent/near-adjacent column-chunk ranges of one read are *coalesced*
    into single ranged GETs (bounded byte waste buys a large request-count
    reduction), and
  * SPAX footers are served from a shared :class:`FooterCache` keyed by
    ``(object key, etag)``, so F fragments scanning G partitions parse each
    footer exactly once per object version.

The *output handler* serializes, compresses, and buffers batches and writes
the worker's complete result as a single object.

Both handlers are decoupled from query execution and account simulated
request latencies under a bounded request pool (the analog of the dedicated
I/O thread pool in the paper): a read's simulated time is the pool makespan
over *all* requests it issued — footer fetches, data fetches, and straggler
re-triggers alike.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from repro_torch.storage import pax
from repro_torch.storage.object_store import ObjectStore

COALESCE_GAP_BYTES = 32 << 10


@dataclasses.dataclass
class IoStats:
    requests: int = 0
    retriggers: int = 0
    bytes: int = 0
    sim_time_s: float = 0.0          # makespan under the request pool
    row_groups_read: int = 0
    row_groups_pruned: int = 0
    footer_hits: int = 0             # footer served from the shared cache
    coalesced_chunks: int = 0        # chunk fetches merged into ranged GETs
    hedges: int = 0                  # cost-model-priced duplicate GETs

    def merge(self, other: "IoStats") -> None:
        self.requests += other.requests
        self.retriggers += other.retriggers
        self.bytes += other.bytes
        self.sim_time_s += other.sim_time_s
        self.row_groups_read += other.row_groups_read
        self.row_groups_pruned += other.row_groups_pruned
        self.footer_hits += other.footer_hits
        self.coalesced_chunks += other.coalesced_chunks
        self.hedges += other.hedges


@dataclasses.dataclass
class _LatencyLog:
    """Per-read request latencies, combined into one pool makespan.

    ``effective`` holds one entry per *logical* fetch (re-triggered
    duplicates race the original; the earliest completion wins), while
    ``busy`` holds one entry per *issued* request — a duplicate cannot be
    cancelled, so its full latency occupies a pool slot either way.
    """

    effective: list[float] = dataclasses.field(default_factory=list)
    busy: list[float] = dataclasses.field(default_factory=list)


def _pool_makespan(lat: _LatencyLog, pool: int) -> float:
    """LPT lower-bound approximation of running the read on the pool."""
    if not lat.effective:
        return 0.0
    return max(max(lat.effective), sum(lat.busy) / max(pool, 1))


class FooterCache:
    """Shared (session-scoped) SPAX footer cache keyed by key + etag.

    Thread-safe: worker fragments on the platform's thread pool consult
    one instance. A changed etag (object overwritten) misses and the
    stale entry is replaced; capacity is bounded FIFO.
    """

    def __init__(self, max_entries: int = 8192) -> None:
        self.max_entries = max_entries
        self._entries: dict[str, tuple[str, pax.PaxFooter]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str, etag: str) -> pax.PaxFooter | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] == etag:
                self.hits += 1
                return entry[1]
            self.misses += 1
            return None

    def put(self, key: str, etag: str, footer: pax.PaxFooter) -> None:
        with self._lock:
            while len(self._entries) >= self.max_entries:
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = (etag, footer)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class InputHandler:
    """Ranged, parallel, straggler-retriggering PAX reader."""

    def __init__(self, store: ObjectStore, *, pool_size: int = 16,
                 straggler_timeout_s: float = 0.2, max_retriggers: int = 2,
                 footer_cache: FooterCache | None = None,
                 coalesce_gap: int = COALESCE_GAP_BYTES,
                 cost_model=None):
        # coalesce_gap: max wasted bytes between chunks sharing one GET;
        # 0 merges only strictly adjacent chunks, negative disables
        # coalescing (one GET per chunk)
        self.store = store
        self.pool_size = pool_size
        self.straggler_timeout_s = straggler_timeout_s
        self.max_retriggers = max_retriggers
        self.footer_cache = footer_cache if footer_cache is not None \
            else FooterCache()
        self.coalesce_gap = coalesce_gap
        # hedged reads: with a cost model attached, the re-trigger
        # timeout is not a constant but the tier's break-even point —
        # hedge exactly when waiting longer costs more GiB-seconds than
        # the duplicate request costs in read-request cents
        self.hedged = cost_model is not None
        if self.hedged:
            self.straggler_timeout_s = cost_model.hedge_timeout_s(store.tier)

    # -- single requests with retriggering ---------------------------------
    def _get(self, key: str, rng: tuple[int, int] | None, stats: IoStats,
             lat: _LatencyLog) -> bytes:
        """Issue one ranged GET; re-trigger if the (simulated) first-byte
        latency exceeds the timeout. All issued requests are charged and
        occupy the request pool; the fetch's effective latency is the
        earliest completion (racing duplicates)."""
        res = self.store.get(key, rng)
        stats.requests += 1
        stats.bytes += res.nbytes
        lat.busy.append(res.sim_latency_s)
        effective = res.sim_latency_s
        deadline = self.straggler_timeout_s
        retriggers = 0
        while effective > deadline and retriggers < self.max_retriggers:
            try:
                retry = self.store.get(key, rng)
            except Exception:
                # a failed duplicate never hurts: the original request
                # already returned the bytes — stop hedging this fetch
                break
            stats.requests += 1
            stats.retriggers += 1
            if self.hedged:
                stats.hedges += 1
            stats.bytes += retry.nbytes
            lat.busy.append(retry.sim_latency_s)
            effective = min(effective, deadline + retry.sim_latency_s)
            deadline += self.straggler_timeout_s
            retriggers += 1
        lat.effective.append(effective)
        return res.data

    def read_footer(self, key: str, stats: IoStats,
                    lat: _LatencyLog | None = None) -> pax.PaxFooter:
        """Fetch-or-recall the footer. A cache hit issues zero requests —
        the metadata of a partition is parsed once per object version no
        matter how many fragments scan it."""
        lat = lat if lat is not None else _LatencyLog()
        etag = self.store.etag(key)
        footer = self.footer_cache.get(key, etag)
        if footer is not None:
            stats.footer_hits += 1
            return footer
        size = self.store.size(key)
        tail = self._get(key, (size - pax.TAIL_LEN, pax.TAIL_LEN), stats,
                         lat)
        off, length = pax.footer_byte_range(size, tail)
        footer_bytes = self._get(key, (off, length), stats, lat)
        footer = pax.parse_footer(footer_bytes)
        self.footer_cache.put(key, etag, footer)
        return footer

    def read_table(self, key: str, columns: Sequence[str] | None = None,
                   predicates: Sequence[pax.ZonePredicate] = (),
                   ) -> tuple[dict[str, np.ndarray], pax.PaxFooter, IoStats]:
        """Read (a projection of) one PAX object with zone-map pruning.

        Returns concatenated column arrays for surviving row groups only.
        Chunk fetches are planned from the (cached) footer, merged into
        coalesced ranged GETs, and their latencies — footer and
        re-triggered duplicates included — combine into one pool
        makespan.
        """
        stats = IoStats()
        lat = _LatencyLog()
        cols, footer = self._read_object(key, columns, predicates, stats,
                                         lat)
        stats.sim_time_s += _pool_makespan(lat, self.pool_size)
        return cols, footer, stats

    def read_tables(self, keys: Sequence[str],
                    columns: Sequence[str] | None = None,
                    predicates: Sequence[pax.ZonePredicate] = (),
                    ) -> tuple[list[dict[str, np.ndarray]], IoStats]:
        """Read many PAX objects as *one parallel batch*.

        A worker scanning several scan units — or the full producer ×
        partition grid of an exchange — issues the requests of all
        objects through its one bounded request pool, so the batch's
        simulated time is a single pool makespan over every request
        rather than a sum of per-object reads. This is what keeps a
        deliberately small (cost-optimal) adaptive fleet from paying
        object-count × first-byte-latency serially.
        """
        stats = IoStats()
        lat = _LatencyLog()
        out = [self._read_object(k, columns, predicates, stats, lat)[0]
               for k in keys]
        stats.sim_time_s += _pool_makespan(lat, self.pool_size)
        return out, stats

    def prefetch_tables(self, keys: Sequence[str],
                        columns: Sequence[str] | None = None,
                        predicates: Sequence[pax.ZonePredicate] = (),
                        ) -> "Prefetch":
        """Start a ``read_tables`` batch on a background thread and
        return immediately — the double-buffering half of pipelined
        consumption: a fragment collects the *previous* batch's arrays
        (and feeds its kernel) while the next top-up batch is in flight.
        The wall-clock overlap is real (two host threads); the simulated
        overlap is accounted by the worker's overlap term, not here —
        the returned ``IoStats`` still carries the batch's full pool
        makespan."""
        return Prefetch(self, keys, columns, predicates)

    def _read_object(self, key: str, columns, predicates, stats: IoStats,
                     lat: _LatencyLog,
                     ) -> tuple[dict[str, np.ndarray], pax.PaxFooter]:
        """One object's footer + chunk reads, accounted into a shared
        latency log (the caller turns the log into a pool makespan)."""
        footer = self.read_footer(key, stats, lat)
        names = list(columns) if columns is not None else [
            c.name for c in footer.columns]
        if footer.n_rows == 0:
            # the footer alone proves the partition is empty: skip every
            # chunk request
            return ({n: np.empty((0,), dtype=footer.spec(n).np_dtype())
                     for n in names}, footer)
        keep = pax.surviving_row_groups(footer, predicates)
        stats.row_groups_read += len(keep)
        stats.row_groups_pruned += len(footer.row_groups) - len(keep)

        reqs = pax.plan_chunk_requests(footer, names, keep)
        chunks: dict[tuple[int, str], np.ndarray] = {}
        for off, length, members in pax.coalesce_ranges(reqs,
                                                        self.coalesce_gap):
            data = self._get(key, (off, length), stats, lat)
            stats.coalesced_chunks += len(members) - 1
            for m in members:
                spec = footer.spec(m.column)
                meta = footer.row_groups[m.group].chunks[m.column]
                chunks[(m.group, m.column)] = pax.decompress_chunk(
                    spec, meta.raw_len,
                    data[m.off - off:m.off - off + m.length],
                    footer.codec)

        out = {}
        for n in names:
            spec = footer.spec(n)
            parts = [chunks[(gi, n)] for gi in keep]
            if parts:
                out[n] = np.concatenate(parts)
            else:
                out[n] = np.empty((0,), dtype=spec.np_dtype())
        return out, footer


class Prefetch:
    """In-flight background ``read_tables`` batch (see
    ``InputHandler.prefetch_tables``). ``result()`` joins the reader
    thread and returns ``(tables, IoStats)``, re-raising any reader
    failure in the caller's thread."""

    def __init__(self, handler: InputHandler, keys, columns, predicates):
        self._box: list = []
        self._keys = list(keys)

        def _run() -> None:
            try:
                self._box.append(handler.read_tables(
                    self._keys, columns, predicates))
            except BaseException as e:  # noqa: BLE001 - re-raised in result
                self._box.append(e)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="prefetch-reader")
        self._thread.start()

    @property
    def keys(self) -> list[str]:
        return self._keys

    def result(self) -> tuple[list[dict[str, np.ndarray]], IoStats]:
        self._thread.join()
        out = self._box[0]
        if isinstance(out, BaseException):
            raise out
        return out


class OutputHandler:
    """Buffers result batches, serializes once, writes a single object."""

    def __init__(self, store: ObjectStore,
                 row_group_rows: int = 65536) -> None:
        self.store = store
        self.row_group_rows = row_group_rows
        self._batches: list[dict[str, np.ndarray]] = []

    def append(self, batch: dict[str, np.ndarray]) -> None:
        self._batches.append(batch)

    def finish(self, key: str, schema: Sequence[pax.ColumnSpec],
               splits: Sequence[int] | None = None) -> IoStats:
        """Write the buffered batches as one object. ``splits`` forces
        row-group boundaries at the given row indices (exchange writers
        align groups to partition boundaries for exact zone pruning)."""
        stats = IoStats()
        if self._batches:
            columns = {
                c.name: np.concatenate([b[c.name] for b in self._batches])
                for c in schema}
        else:
            columns = {c.name: np.empty((0,), dtype=c.np_dtype())
                       for c in schema}
        data = pax.write_pax(columns, schema, self.row_group_rows,
                             splits=splits)
        # torn-write protection: a producer killed mid-PUT must never
        # leave a readable partial object at the final key
        res = self.store.put_committed(key, data)
        stats.requests += 1
        stats.bytes += res.nbytes
        stats.sim_time_s += res.sim_latency_s
        self._batches.clear()
        return stats
