"""First-class exchange subsystem: pluggable shuffle strategies.

Skyrise shuffles run entirely through serverless storage, so exchange
cost is dominated by *request counts*: the naive layout writes one
object per producer × partition pair and reads the whole grid — O(n·m)
requests that explode at wide fan-out (the pattern Lambada's multi-level
exchange collapses). This module owns how a pipeline's hash-partitioned
output is materialized and read back; everything else (planner, cost
model, adaptive layer, engine) only names a strategy.

Strategies (registry below, ``register_strategy`` to add one):

  * ``direct`` — the producer × partition grid
    (``f{g}/d{d}.spax``): bit-compatible with the historical layout.
    Requests: n·m PUTs, n·m GETs.
  * ``combining`` — each producer *combines* its whole destination grid
    into ONE object (``f{g}/all.spax``) whose rows are sorted by a
    stored ``__dest`` column and whose row groups split at partition
    boundaries, so consumers prune to their partition via zone maps and
    fetch it with one coalesced ranged GET per producer. Requests:
    n PUTs, ≤ n·m (smaller, ranged) GETs.
  * ``multilevel`` — Lambada-style two-phase tree shuffle: producers
    write combined intermediates (under ``l0/``), a merge wave of
    G = ⌈√n⌉ workers re-partitions them — re-combining mergeable
    partial-aggregate states when the KMV sketches say the key
    cardinality is well below the row count — and writes a G×m grid;
    consumers read O(√n·m) objects instead of O(n·m).

The *materialized* layout is recorded in the registry entry
(``partitioning["layout"]``: "grid" | "combined"), which is what
consumers dispatch on — so cached results produced under any strategy
stay readable by any plan, and the semantic hash (caching/dedup) is
untouched by strategy choice.
"""

from __future__ import annotations

import math
import time
from typing import Sequence

import numpy as np

from repro_torch.exec import operators as ops
from repro_torch.storage import pax
from repro_torch.storage.io_handlers import InputHandler, OutputHandler
from repro_torch.storage.pax import ColumnSpec, ZonePredicate

# Stored destination-partition column of combined exchange objects.
DEST_COL = "__dest"
_DEST_SPEC = ColumnSpec(DEST_COL, "num", "<i4")


def merge_group_count(producers: int) -> int:
    """Merge-wave width of the multi-level exchange: ⌈√producers⌉."""
    return max(1, math.isqrt(max(producers - 1, 0)) + 1)


# -- strategy objects -----------------------------------------------------------

class ExchangeStrategy:
    """How one hash exchange is partitioned, materialized, and read."""

    name = ""
    layout = "grid"          # materialized layout consumers dispatch on
    # Whether this strategy's layout supports *incremental* consumption:
    # each producer's contribution is a self-contained object (or object
    # row-group) readable the moment that producer publishes its partial
    # manifest entry, so consumers can start on a subset of producers and
    # top up. All built-in layouts qualify — direct and combining write
    # per-producer objects; multilevel's consumer-facing grid is written
    # per merge *group*, each itself an incremental reader of the l0
    # stream. A strategy that interleaves producers inside shared objects
    # would set this False and consumers would fall back to the barrier.
    incremental = True

    # -- request-count math (the cost model's per-strategy estimates) ----
    def written_objects(self, producers: int, n_dest: int) -> int:
        raise NotImplementedError

    def merge_workers(self, producers: int) -> int:
        return 0

    def producer_puts(self, n_dest: int) -> int:
        """Exchange PUTs issued by one producer fragment."""
        return 1

    def producer_requests(self, producers: int, n_dest: int) -> int:
        """Estimated storage requests on the producer side of the
        barrier: exchange PUTs plus, for multi-level, the merge wave's
        reads (footers included) and writes. This is the figure EXPLAIN
        ANALYZE compares against the observed count."""
        raise NotImplementedError

    def consumer_requests(self, producers: int, n_dest: int) -> int:
        """Estimated data GETs for all consumers to read the exchange
        once (footer fetches excluded: the shared cache pays them once
        per object)."""
        raise NotImplementedError

    # -- producer write path ---------------------------------------------
    def write(self, store, result: dict[str, np.ndarray],
              schema: Sequence[ColumnSpec], part: dict, prefix: str,
              me: int, stats) -> tuple[list[str], list[dict]]:
        """Materialize one producer fragment's hash-partitioned output;
        returns (object keys, per-destination stats for the exchange
        manifest). ``stats`` is the fragment's ``FragmentStats``."""
        raise NotImplementedError


class DirectStrategy(ExchangeStrategy):
    name = "direct"
    layout = "grid"

    def written_objects(self, producers, n_dest):
        return producers * n_dest

    def producer_puts(self, n_dest):
        return n_dest

    def producer_requests(self, producers, n_dest):
        return producers * n_dest

    def consumer_requests(self, producers, n_dest):
        return producers * n_dest

    def write(self, store, result, schema, part, prefix, me, stats):
        tier = part.get("tier", "s3-standard")
        out = OutputHandler(store.with_tier(tier))
        h = ops.np_key_hash(result, list(part["keys"]))
        dest = (h % np.uint64(part["n_dest"])).astype(np.int32)
        out_keys, part_stats = [], []
        for d in range(part["n_dest"]):
            sel = dest == d
            out.append({c: v[sel] for c, v in result.items()})
            key = f"{prefix}/f{me:04d}/d{d:04d}.spax"
            st = out.finish(key, schema)
            stats.account(tier, st, write=True)
            out_keys.append(key)
            part_stats.append({"rows": int(sel.sum()), "bytes": st.bytes,
                               "kmv": ops.kmv_sketch(h[sel]),
                               "write_s": st.sim_time_s})
        return out_keys, part_stats


def _write_combined(store, result, schema, part, prefix, me, stats,
                    subdir: str = "", tier_override: str | None = None):
    """One combined object per producer: rows stably sorted by
    destination, row groups split at partition boundaries, ``__dest``
    stored so both zone maps and the merge wave can route by it."""
    tier = tier_override or part.get("tier", "s3-standard")
    n_dest = part["n_dest"]
    h = ops.np_key_hash(result, list(part["keys"]))
    dest = (h % np.uint64(n_dest)).astype(np.int32)
    # stable: rows keep their original order within each destination, so
    # per-partition row sequences are identical to the direct grid's
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=n_dest)
    splits = [int(s) for s in np.cumsum(counts)[:-1]]
    combined = {c: v[order] for c, v in result.items()}
    combined[DEST_COL] = dest[order]
    out = OutputHandler(store.with_tier(tier))
    out.append(combined)
    key = f"{prefix}/{subdir}f{me:04d}/all.spax"
    st = out.finish(key, list(schema) + [_DEST_SPEC], splits=splits)
    stats.account(tier, st, write=True)
    n = max(int(counts.sum()), 1)
    part_stats = [{"rows": int(counts[d]),
                   "bytes": int(st.bytes * counts[d] / n),
                   "kmv": ops.kmv_sketch(h[dest == d]),
                   "write_s": st.sim_time_s * counts[d] / n}
                  for d in range(n_dest)]
    return [key], part_stats


class CombiningStrategy(ExchangeStrategy):
    name = "combining"
    layout = "combined"

    def written_objects(self, producers, n_dest):
        return producers

    def producer_requests(self, producers, n_dest):
        return producers

    def consumer_requests(self, producers, n_dest):
        return producers * n_dest

    def write(self, store, result, schema, part, prefix, me, stats):
        return _write_combined(store, result, schema, part, prefix, me,
                               stats)


class MultiLevelStrategy(ExchangeStrategy):
    name = "multilevel"
    layout = "grid"          # the merge wave materializes a G×m grid

    def written_objects(self, producers, n_dest):
        return producers + merge_group_count(producers) * n_dest

    def merge_workers(self, producers):
        return merge_group_count(producers)

    def producer_requests(self, producers, n_dest):
        # l0 PUTs + merge reads (1 data + 2 footer GETs per l0 object)
        # + merge-wave grid PUTs
        g = merge_group_count(producers)
        return producers + 3 * producers + g * n_dest

    def consumer_requests(self, producers, n_dest):
        return merge_group_count(producers) * n_dest

    def write(self, store, result, schema, part, prefix, me, stats):
        # l0 intermediates are short-lived (read once by the merge wave,
        # then deleted) — the cost model may route them to a hotter tier
        # than the grid the consumers read
        return _write_combined(store, result, schema, part, prefix, me,
                               stats, subdir="l0/",
                               tier_override=part.get("l0_tier"))


STRATEGIES: dict[str, ExchangeStrategy] = {}


def register_strategy(strategy: ExchangeStrategy) -> None:
    STRATEGIES[strategy.name] = strategy


for _s in (DirectStrategy(), CombiningStrategy(), MultiLevelStrategy()):
    register_strategy(_s)


def get_strategy(name: str) -> ExchangeStrategy:
    return STRATEGIES[name or "direct"]


# -- consumer read planning -----------------------------------------------------

def plan_exchange_read(part: dict, prefix: str,
                       n_producers: int | Sequence[int],
                       mode: str, me: int, n_fragments: int,
                       assigned: list[int] | None,
                       nonempty: list[int] | None,
                       ) -> tuple[list[str], list[ZonePredicate], bool]:
    """Object keys (+ zone predicates, + local-repartition flag) one
    consumer fragment must read, for any materialized layout.

    ``part`` is the *registry entry's* partitioning dict — the layout of
    what was actually written, which may differ from the reader's plan
    (cached results, adapted strategies). ``assigned`` is the adaptive
    partition assignment, ``nonempty`` the provably non-empty partition
    ids of this source. ``n_producers`` may be an explicit producer-id
    subset instead of a count: pipelined consumers plan one top-up batch
    at a time over exactly the ids newly present in the partial manifest.
    """
    producers: Sequence[int] = range(n_producers) \
        if isinstance(n_producers, int) else n_producers
    if part["kind"] != "hash":
        return ([f"{prefix}/f{g:04d}/out.spax" for g in producers],
                [], False)
    layout = part.get("layout", "grid")
    ds: list[int] | None
    local_filter = False
    if mode == "partition":
        if assigned is not None:
            ds = [d for d in assigned
                  if nonempty is None or d in nonempty]
        elif part["n_dest"] == n_fragments:
            ds = [me]
        else:
            # Cached result with a different fan-out: read everything
            # and re-partition locally (correct under any layout).
            local_filter = True
            ds = None
    else:  # mode == all
        ds = [d for d in range(part["n_dest"])
              if nonempty is None or d in nonempty]
    if layout == "combined":
        if ds is not None and not ds:
            return [], [], False
        keys = [f"{prefix}/f{g:04d}/all.spax" for g in producers]
        preds = [] if ds is None or len(ds) == part["n_dest"] else \
            [ZonePredicate(DEST_COL, "in", tuple(ds))]
        return keys, preds, local_filter
    if ds is None:
        ds = list(range(part["n_dest"]))
    keys = [f"{prefix}/f{g:04d}/d{d:04d}.spax"
            for g in producers for d in ds]
    return keys, [], local_filter


# -- multi-level merge wave -----------------------------------------------------

def combine_spec(op: dict) -> dict | None:
    """Merge-wave combine spec when the exchanged payload is mergeable
    partial-aggregate state (the pipeline ends in ``partial_agg``), else
    None (join exchanges re-bucket raw rows untouched)."""
    if op.get("t") != "partial_agg":
        return None
    return {"group_cols": list(op["group_cols"]),
            "aggs": [[name, ops.MERGE_FN[fn]]
                     for name, fn, _ in op["aggs"]]}


def execute_merge(store, spec: dict, footer_cache=None, cost_model=None):
    """Run one merge-wave fragment of a multi-level exchange.

    Reads its producer group's combined l0 intermediates, optionally
    re-combines partial-aggregate states (per-worker partial aggregation
    before the final exchange write), and writes its slice of the final
    G×m grid — the layout consumers read as a plain direct grid.

    When the spec carries an l0 ``manifest_key`` (pipelined execution),
    the merge fragment starts on the *partial* l0 stream: it drains the
    objects already published, then tops up batch-by-batch as further
    producers land — watching manifest versions, never polling — until
    the stream is sealed. Assembly order is sorted producer id either
    way, so the merged grid is bit-identical to the barrier run's.
    """
    from repro_torch.exec.fragment import FragmentResult, FragmentStats
    op = spec["op"]
    tier = op.get("tier", "s3-standard")
    l0_tier = op.get("l0_tier") or tier
    stats = FragmentStats()
    view = store.with_tier(tier)
    handler = InputHandler(store.with_tier(l0_tier),
                           footer_cache=footer_cache,
                           cost_model=cost_model)
    schema = [ColumnSpec(s["name"], s["kind"], s["dtype"])
              for s in op["schema"]]
    names = [c.name for c in schema] + [DEST_COL]

    def in_group(g: int) -> bool:
        return g % op["n_groups"] == op["group"]

    parts_by_g: dict[int, dict] = {}

    def drain(gids: list[int]) -> None:
        keys = [f"{op['l0_prefix']}/f{g:04d}/all.spax" for g in gids]
        parts, st = handler.read_tables(keys, names)
        if parts_by_g:
            stats.topups += 1
        else:
            stats.first_input_s = st.sim_time_s
        stats.account(l0_tier, st, write=False)
        parts_by_g.update(zip(gids, parts))

    manifest_key = op.get("manifest_key")
    if manifest_key is None:
        drain([g for g in range(op["producers"]) if in_group(g)])
    else:
        from repro_torch.core.registry import read_manifest
        stats.pipelined = True
        kv = store.with_tier("dynamodb")
        deadline = time.time() + float(op.get("wait_timeout_s") or 600.0)
        while True:
            token = kv.version(manifest_key)
            man = read_manifest(kv, manifest_key)
            if man is None:
                # stream retired with its entry: planned count is final
                man = {"done": {str(g): None
                                for g in range(op["producers"])},
                       "complete": True}
            if man.get("aborted"):
                raise RuntimeError("upstream producer pipeline aborted")
            fresh = sorted(g for g in map(int, man.get("done") or {})
                           if in_group(g) and g not in parts_by_g)
            if fresh:
                drain(fresh)
            if man.get("complete"):
                break
            if time.time() >= deadline:
                raise TimeoutError("l0 stream never sealed: producer "
                                   "pipeline lost without abort")
            kv.watch(manifest_key, token, timeout_s=1.0)

    ordered = [parts_by_g[g] for g in sorted(parts_by_g)]
    cols = {c.name: np.concatenate([p[c.name] for p in ordered])
            if ordered else np.empty((0,), np.dtype(c.dtype))
            for c in schema}
    dest = np.concatenate([p[DEST_COL] for p in ordered]) if ordered \
        else np.empty((0,), np.int32)
    stats.rows_in = int(dest.shape[0])

    t0 = time.perf_counter()
    combine = op.get("combine")
    out = OutputHandler(view)
    prefix = spec["output"]["prefix"]
    out_keys, part_stats = [], []
    rows_out = 0
    for d in range(op["n_dest"]):
        sel = dest == d
        dcols = {c: v[sel] for c, v in cols.items()}
        if combine is not None and sel.any():
            dcols = ops.np_combine_partials(
                dcols, list(combine["group_cols"]),
                [(name, fn) for name, fn in combine["aggs"]])
        dcols = {c.name: dcols[c.name].astype(np.dtype(c.dtype))
                 for c in schema}
        n_rows = len(next(iter(dcols.values()))) if dcols else 0
        rows_out += n_rows
        out.append(dcols)
        key = f"{prefix}/f{op['group']:04d}/d{d:04d}.spax"
        wst = out.finish(key, schema)
        stats.account(tier, wst, write=True)
        out_keys.append(key)
        h = ops.np_key_hash(dcols, list(op["keys"])) if n_rows else \
            np.empty((0,), np.uint64)
        part_stats.append({"rows": n_rows, "bytes": wst.bytes,
                           "kmv": ops.kmv_sketch(h),
                           "write_s": wst.sim_time_s})
    stats.rows_out = rows_out
    stats.compute_s += time.perf_counter() - t0
    return FragmentResult(out_keys, stats, part_stats)
