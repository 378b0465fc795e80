"""Query-worker fragment execution (paper section 3.3).

A worker deserializes its invocation payload (the fragment spec), loads its
input partitions through the storage input handler, executes the fragment's
operator chain as one program over fixed-capacity torch blocks on the
session's device (a fused CUDA kernel where ``exec.lower`` matched the
chain, the generic torch operators otherwise), and writes exactly one
deterministic output object per destination — making re-execution
idempotent: racing duplicate workers overwrite identical bytes.

On the card each fragment runs its device work on a stream of its own:
the platform runs up to ``quota`` fragments at once on threads, so a
device-wide synchronize would charge one fragment for another's work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time

import numpy as np
import torch

from repro_torch.exec import exchange
from repro_torch.exec import lower
from repro_torch.exec import operators as ops
from repro_torch.kernels import bloom as bloomlib
from repro_torch.exec.batch import (Block, bucket_capacity, from_numpy,
                                    resolve_device, to_numpy)
from repro_torch.exec.expr import expr_from_dict
from repro_torch.storage import pax
from repro_torch.storage.io_handlers import (FooterCache, InputHandler, IoStats,
                                       OutputHandler)
from repro_torch.storage.object_store import ObjectStore


class SpanLog:
    """The spans one traced fragment records on its worker thread, where
    no observer is in reach; the engine relays them with the fragment's
    span as the parent of the outermost ones. Spans nest as the calls
    do: each ``begin`` is a child of the innermost span still open."""

    def __init__(self):
        self.thread = threading.current_thread().name
        # [name, t0_ns, t1_ns, index of the parent row or None, attrs]
        self.rows: list[list] = []
        self._open: list[int] = []

    def begin(self, name: str, **attrs) -> None:
        parent = self._open[-1] if self._open else None
        self._open.append(len(self.rows))
        self.rows.append([name, time.perf_counter_ns(), 0, parent, attrs])

    def end(self, **attrs) -> None:
        row = self.rows[self._open.pop()]
        row[2] = time.perf_counter_ns()
        row[4].update(attrs)


@dataclasses.dataclass
class FragmentStats:
    rows_in: int = 0
    rows_out: int = 0
    sim_io_s: float = 0.0
    compute_s: float = 0.0
    requests: int = 0
    retriggers: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    footer_cache_hits: int = 0
    kernel: str = ""       # fused CUDA kernel this fragment ran on ("" = generic)
    # Pipelined consumption: this fragment read at least one input from a
    # partial manifest. ``first_input_s`` is the simulated makespan of the
    # first available batch (the fragment's exposed input latency);
    # ``topups`` counts later batches, whose read time double-buffers
    # against compute — the worker turns that into ``overlap_saved_s``
    # simulated seconds hidden from its runtime (CostModel overlap term).
    pipelined: bool = False
    first_input_s: float = 0.0
    topups: int = 0
    overlap_saved_s: float = 0.0
    # probe rows the semi-join Bloom filter killed before partitioning
    # (exact: counted against the predicate-surviving stream)
    semijoin_killed: int = 0
    # per-tier request/byte accounting for the cost model
    tier_ops: dict = dataclasses.field(default_factory=dict)
    # the fragment's spans when its spec carries ``trace``, else None
    spans: SpanLog | None = None

    def account(self, tier: str, st: IoStats, *, write: bool) -> None:
        t = self.tier_ops.setdefault(
            tier, {"get": 0, "put": 0, "bytes_read": 0, "bytes_written": 0})
        if write:
            t["put"] += st.requests
            t["bytes_written"] += st.bytes
        else:
            t["get"] += st.requests
            t["bytes_read"] += st.bytes
            self.retriggers += st.retriggers
            self.footer_cache_hits += st.footer_hits
        self.requests += st.requests
        self.bytes_read += 0 if write else st.bytes
        self.bytes_written += st.bytes if write else 0
        self.sim_io_s += st.sim_time_s


@dataclasses.dataclass
class FragmentResult:
    output_keys: list[str]
    stats: FragmentStats
    # Per-destination output statistics (rows, bytes, distinct-key KMV
    # sketch) — the worker's contribution to the exchange manifest that
    # the adaptive re-optimizer consumes at the next stage barrier.
    partition_stats: list[dict] = dataclasses.field(default_factory=list)
    # serialized Bloom filter words over this fragment's join-key column
    # (build side of an eligible repartition join; OR-merged and
    # published by the coordinator)
    bloom: bytes | None = None


# -- program construction -------------------------------------------------------

# Program cache, shared across fragments, pipelines, and queries of the
# process: the key is the *canonical* serialized op tree (fragment
# payloads of one pipeline share it verbatim) plus the dispatch mode and
# the kernel tiling, the value a built program (operator closures, or a
# lowered kernel call with its compiled expression program, uploaded to
# the card once). Every same-shaped fragment — of any query — reuses it.
_FN_CACHE: dict[tuple[str, bool], tuple] = {}
_FN_CACHE_LOCK = threading.Lock()


def _plan_key(op: dict) -> str:
    return json.dumps(op, sort_keys=True, separators=(",", ":"))


def _build(op: dict, leaves: list[tuple[str, dict]]):
    """Recursively build a pure function over named leaf blocks."""
    t = op["t"]
    if t in ("scan_table", "scan_exchange"):
        leaf_id = f"in{len(leaves)}"
        leaves.append((leaf_id, op))
        return lambda blocks: blocks[leaf_id]
    if t == "filter":
        child = _build(op["child"], leaves)
        f = ops.make_filter(expr_from_dict(op["pred"]))

        def run_filter(blocks):
            cols, mask = child(blocks)
            return f(cols, mask)
        return run_filter
    if t == "project":
        child = _build(op["child"], leaves)
        f = ops.make_project([(n, expr_from_dict(e))
                              for n, e in op["exprs"]])

        def run_project(blocks):
            cols, mask = child(blocks)
            return f(cols, mask)
        return run_project
    if t in ("partial_agg", "merge_agg"):
        child = _build(op["child"], leaves)
        aggs = [(n, fn, expr_from_dict(a) if a else None)
                for n, fn, a in op["aggs"]]
        if op["strategy"] == "direct":
            f, _ = ops.make_direct_agg(op["group_cols"], op["sizes"], aggs)
        else:
            f = ops.make_sort_agg(op["group_cols"], aggs)

        def run_agg(blocks):
            cols, mask = child(blocks)
            return f(cols, mask)
        return run_agg
    if t == "semijoin_probe":
        # generic arm of the fused Bloom probe (exec.lower's
        # ``bloom_filter`` arm): same hash family, same reserved
        # ``__bloom_pass`` column, bit for bit. The filter words arrive
        # through the runtime ``__bloom`` pseudo-leaf, so the cached
        # program never holds a query's filter contents.
        child = _build(op["child"], leaves)
        key, bits, k = op["key"], int(op["bits"]), int(op["k"])
        leaves.append(("__bloom", {"t": "bloom_words"}))

        def run_semijoin(blocks):
            cols, mask = child(blocks)
            words = blocks["__bloom"][0]["words"]
            hit = bloomlib.bloom_probe_plain(cols[key], words, bits,
                                             k) & mask
            out = dict(cols)
            out["__bloom_pass"] = hit.to(torch.int32)
            return out, mask
        return run_semijoin
    if t == "join":
        probe = _build(op["probe"], leaves)
        build = _build(op["build"], leaves)
        f = ops.make_pk_join_probe(op["probe_key"], op["build_key"],
                                   op["payload"])

        def run_join(blocks):
            pcols, pmask = probe(blocks)
            bcols, bmask = build(blocks)
            return f(pcols, pmask, bcols, bmask)
        return run_join
    raise TypeError(t)


def _compiled(op: dict, spans: SpanLog | None = None):
    """(program, leaves, kernel name, cache key) for an op tree: kernel
    dispatch first (``repro_torch.exec.lower``), generic torch chain
    otherwise. A miss that builds the program records ``fragment.build``
    in ``spans``."""
    # read the dispatch switch once: key and lowering gate must agree, or
    # a concurrent toggle could park a generic program under a fused key
    dispatch = lower.enabled()
    if dispatch:
        # cheap match-only pass: the kernel's roofline tiling joins the
        # cache key (a tiling change must not reuse a stale trace), and
        # ``final`` ops whose top-k arm misses dispatch on their child —
        # the coordinator's host sort still runs either way
        _, tkey, op = lower.dispatch_signature(op)
    else:
        tkey = None
        if op.get("t") == "final":
            op = op["child"]
    key = (_plan_key(op), dispatch, tkey)
    entry = _FN_CACHE.get(key)      # one dict read: atomic under the GIL
    if entry is not None:
        return entry
    if spans is not None:
        spans.begin("fragment.build")
    lowered = lower.lower_fragment(op) if dispatch else None
    if lowered is not None:
        entry = (lowered.fn, lowered.leaves, lowered.kernel, key)
    else:
        leaves: list[tuple[str, dict]] = []
        fn = _build(op, leaves)
        entry = (fn, leaves, "", key)
    if spans is not None:
        spans.end()
    with _FN_CACHE_LOCK:
        return _FN_CACHE.setdefault(key, entry)


# (cache key, leaf capacities) pairs already run once: the first fragment
# hitting a new op×capacity-bucket combination pays the one-time costs
# (kernel library load, program upload, allocator growth) in an
# *untimed* warmup call, so ``compute_s`` — the simulated worker runtime
# — reflects steady-state execution. One-time spikes otherwise
# masquerade as stragglers and draw spurious re-triggers.
_WARM_SHAPES: set = set()


def _warm(fn, key, blocks, sync, spans: SpanLog | None) -> None:
    sig = (key, tuple(sorted((lid, int(mask.shape[0]))
                             for lid, (_, mask) in blocks.items())))
    with _FN_CACHE_LOCK:
        if sig in _WARM_SHAPES:
            return
    if spans is not None:
        spans.begin("fragment.warm")
    fn(blocks)
    sync()
    if spans is not None:
        spans.end()
    with _FN_CACHE_LOCK:
        _WARM_SHAPES.add(sig)


@contextlib.contextmanager
def _device_scope(device: torch.device):
    """Run the fragment's device work on a stream of its own; yields the
    function that waits for that stream (and only for it)."""
    if device.type != "cuda":
        yield lambda: None
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        yield stream.synchronize


# -- input loading ----------------------------------------------------------------

def _load_scan_table(handler: InputHandler, spec: dict, leaf_op: dict,
                     stats: FragmentStats) -> dict[str, np.ndarray]:
    preds = [pax.ZonePredicate(c, o, tuple(v) if isinstance(v, list) else v)
             for c, o, v in leaf_op["zone_preds"]]
    # one batched read: all scan units share the worker's request pool
    parts, st = handler.read_tables(spec["scan_units"],
                                    leaf_op["columns"], preds)
    stats.account("table", st, write=False)
    if not parts:
        return {c: np.empty((0,), np.int64) for c in leaf_op["columns"]}
    return {c: np.concatenate([p[c] for p in parts])
            for c in leaf_op["columns"]}


def _load_scan_exchange(handler_for, store: ObjectStore, spec: dict,
                        leaf_op: dict,
                        stats: FragmentStats) -> dict[str, np.ndarray]:
    src = spec["sources"][leaf_op["source"]]
    if src.get("pipelined"):
        return _load_exchange_pipelined(handler_for, store, spec, leaf_op,
                                        stats)
    part = src["partitioning"]
    tier = part.get("tier", "s3-standard")
    handler = handler_for(tier)
    me, F = spec["fragment"], spec["n_fragments"]
    # Adaptive re-optimization hooks (core.adaptive): ``read_partitions``
    # is this fragment's explicit upstream-partition assignment (fleet
    # re-sizing coarsens the 1:1 fragment↔partition map); per-source
    # ``source_partitions`` lists the provably non-empty partitions, so
    # empty ones are pruned from the read set entirely. The exchange
    # subsystem (repro_torch.exec.exchange) resolves the object keys for the
    # *materialized* layout the registry entry records — a direct grid
    # or per-producer combined objects pruned via __dest zone maps.
    assigned = spec.get("read_partitions")
    nonempty = (spec.get("source_partitions") or {}).get(leaf_op["source"])
    keys, preds, local_filter = exchange.plan_exchange_read(
        part, src["prefix"], src["n_fragments"], leaf_op["mode"], me, F,
        assigned, nonempty)
    names = [c["name"] for c in src["schema"]]
    # One batched read over the whole producer × partition grid: the
    # shared footer cache still skips every chunk request of provably
    # empty partitions, and all objects' requests share one request-pool
    # makespan — a small (cost-optimally shrunk) fleet fetches many
    # partitions concurrently instead of paying per-object first-byte
    # latency serially.
    parts, st = handler.read_tables(keys, names, preds)
    stats.account(tier, st, write=False)
    out = {c: np.concatenate([p[c] for p in parts]) if parts
           else np.empty((0,), np.dtype(s["dtype"]))
           for c, s in zip(names, src["schema"])}
    if local_filter:
        dest = ops.np_hash_dest(out, list(part["keys"]), F)
        sel = dest == me
        out = {c: v[sel] for c, v in out.items()}
    return out


def _read_cost(info) -> int:
    """Estimated read cost of one upstream partition, from its manifest
    entry (0 for retired streams whose entries carry no stats)."""
    return int(info.get("bytes") or 0) if isinstance(info, dict) else 0


def _load_exchange_pipelined(handler_for, store: ObjectStore, spec: dict,
                             leaf_op: dict, stats: FragmentStats,
                             ) -> dict[str, np.ndarray]:
    """Consume an exchange from its *partial* manifest (barrier-free).

    The fragment was admitted once a fraction of its producers had
    published. It drains what exists, then tops up batch-by-batch as
    further manifest entries land — each batch prefetched on a
    background thread while the previous one is collected (double
    buffering), waiting on manifest *versions* between batches. Rows are
    assembled in sorted producer-id order regardless of completion
    order, so the concatenated input — and every byte derived from it —
    is identical to the barrier run's.
    """
    from repro_torch.core.registry import read_manifest
    src = spec["sources"][leaf_op["source"]]
    part = src["partitioning"]
    tier = part.get("tier", "s3-standard")
    handler = handler_for(tier)
    me, F = spec["fragment"], spec["n_fragments"]
    assigned = spec.get("read_partitions")
    nonempty = (spec.get("source_partitions") or {}).get(leaf_op["source"])
    names = [c["name"] for c in src["schema"]]
    kv = store.with_tier("dynamodb")
    mkey = src["manifest_key"]
    deadline = time.time() + float(src.get("wait_timeout_s") or 600.0)
    stats.pipelined = True
    tables: dict[int, list] = {}        # producer id → its tables
    local_filter = False
    pending: tuple | None = None        # (Prefetch, gids, n_keys)

    def collect(pref, gids, n_keys) -> None:
        parts, st = pref.result()
        if tables:
            stats.topups += 1
        else:
            stats.first_input_s = st.sim_time_s
        stats.account(tier, st, write=False)
        per = n_keys // len(gids) if gids else 0
        for i, g in enumerate(gids):
            tables[g] = parts[i * per:(i + 1) * per]

    while True:
        token = kv.version(mkey)
        man = read_manifest(kv, mkey)
        if man is None:
            # stream already retired with its result entry — the entry's
            # producer count is final and every object exists
            man = {"done": {str(g): None
                            for g in range(src["n_fragments"])},
                   "complete": True}
        if man.get("aborted"):
            raise RuntimeError("upstream producer pipeline aborted")
        known = set(tables) | (set(pending[1]) if pending else set())
        done = man.get("done") or {}
        # top-up order: most expensive reads first (per-partition bytes
        # from the partial manifest), so the largest transfers overlap
        # compute the longest; arrival order carries no such signal
        fresh = sorted((g for g in map(int, done) if g not in known),
                       key=lambda g: (-_read_cost(done.get(str(g))), g))
        if fresh:
            keys, preds, lf = exchange.plan_exchange_read(
                part, src["prefix"], fresh, leaf_op["mode"], me, F,
                assigned, nonempty)
            local_filter = local_filter or lf
            nxt = (handler.prefetch_tables(keys, names, preds), fresh,
                   len(keys))
            if pending is not None:
                collect(*pending)   # overlap: next batch is in flight
            pending = nxt
        if man.get("complete"):
            break
        if not fresh:
            if time.time() >= deadline:
                raise TimeoutError("exchange manifest never sealed: "
                                   "producer pipeline lost without abort")
            if stats.spans is not None:
                stats.spans.begin("fragment.wait")
            kv.watch(mkey, token, timeout_s=1.0)
            if stats.spans is not None:
                stats.spans.end()
    if pending is not None:
        collect(*pending)

    ordered: list[dict] = []
    for g in sorted(tables):
        ordered.extend(tables[g])
    out = {c: np.concatenate([p[c] for p in ordered]) if ordered
           else np.empty((0,), np.dtype(s["dtype"]))
           for c, s in zip(names, src["schema"])}
    if local_filter:
        dest = ops.np_hash_dest(out, list(part["keys"]), F)
        sel = dest == me
        out = {c: v[sel] for c, v in out.items()}
    return out


def _block_bytes(blocks: dict) -> int:
    """Bytes of the device tensors a fragment uploaded: every column at
    its bucketed capacity, each mask and the filter words."""
    return sum(t.numel() * t.element_size()
               for cols, mask in blocks.values()
               for t in (*cols.values(), mask))


# -- driver ------------------------------------------------------------------------

def execute_fragment(store: ObjectStore, spec: dict,
                     footer_cache: FooterCache | None = None,
                     cost_model=None, device=None,
                     ) -> FragmentResult:
    """Run one fragment; ``device`` is where its blocks live (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    cache = footer_cache if footer_cache is not None else FooterCache()
    spans = SpanLog() if spec.get("trace") else None
    # Merge-wave fragments of a multi-level exchange are pure host-side
    # re-bucketing (plus partial-state combining): no device program.
    if spec["op"]["t"] == "merge_exchange":
        if spans is not None:
            spans.begin("fragment.merge")
        res = exchange.execute_merge(store, spec, footer_cache=cache,
                                     cost_model=cost_model)
        if spans is not None:
            spans.end(bytes=res.stats.bytes_read, rows=res.stats.rows_in)
            res.stats.spans = spans
        return res
    stats = FragmentStats(spans=spans)
    # One input handler per storage tier, all sharing the (session-scoped)
    # footer cache — every leaf of this fragment reuses them instead of
    # constructing fresh handlers per source.
    handlers: dict[str | None, InputHandler] = {}

    def handler_for(tier: str | None) -> InputHandler:
        if tier not in handlers:
            view = store if tier is None else store.with_tier(tier)
            handlers[tier] = InputHandler(view, footer_cache=cache,
                                          cost_model=cost_model)
        return handlers[tier]

    # Semi-join filter pushdown: a probe-side spec may carry the build
    # side's published Bloom filter. Kernel-eligible filters (single
    # truncated-integer key over a scan → [filter…] chain, the Bloom
    # arm's shape) wrap the op tree for dispatch only — the wrapper joins
    # the compiled-program cache key, never the semantic hash — so the
    # membership test runs in the scan program (the CUDA kernel, or its
    # plain version on the CPU, or the generic arm when dispatch is off);
    # other key and chain shapes kill on the host below. (The reference
    # also wraps project-rooted chains; its generic arm probes them with
    # the same hash family, so the rows killed are the same.)
    op = spec["op"]
    sj = spec.get("semijoin")
    if sj is not None and sj.get("mode") == "u32" and len(sj["key"]) == 1 \
            and lower.bloom_probe_chain(op):
        op = {"t": "semijoin_probe", "key": sj["key"][0],
              "bits": int(sj["bits"]), "k": int(sj["k"]), "child": op}
    fn, leaves, kernel, fn_key = _compiled(op, spans)
    stats.kernel = kernel

    # 1. Load leaf inputs (host side, ranged + pruned + re-triggered reads).
    tables = []
    for leaf_id, leaf_op in leaves:
        if leaf_op["t"] == "bloom_words":
            tables.append((leaf_id, None, 0))
            continue
        if spans is not None:
            spans.begin("fragment.read")
            read_before = stats.bytes_read
        if leaf_op["t"] == "scan_table":
            cols = _load_scan_table(handler_for(None), spec, leaf_op,
                                    stats)
        else:
            cols = _load_scan_exchange(handler_for, store, spec, leaf_op,
                                       stats)
        n = len(next(iter(cols.values()))) if cols else 0
        if spans is not None:
            spans.end(bytes=stats.bytes_read - read_before, rows=n)
        stats.rows_in += n
        tables.append((leaf_id, cols, n))

    # 2. Copy the blocks to the device and run the program there (one-time
    # costs paid untimed, once per op×capacity bucket — simulated runtime
    # is steady-state compute, timed on this fragment's own stream).
    with _device_scope(device) as sync:
        if spans is not None:
            spans.begin("fragment.upload")
        blocks = {}
        for leaf_id, cols, n in tables:
            if cols is None:        # the filter words, uploaded once
                words = np.frombuffer(sj["words"], dtype=np.uint32)
                blocks[leaf_id] = (
                    {"words": bloomlib.words_tensor(words, device)},
                    torch.ones((1,), dtype=torch.bool, device=device))
                continue
            blk = from_numpy(cols, bucket_capacity(n), device)
            blocks[leaf_id] = (blk.columns, blk.mask)
        if spans is not None:
            spans.end(bytes=_block_bytes(blocks),
                      rows=sum(n for _, _, n in tables))
        _warm(fn, fn_key, blocks, sync, spans)
        sync()
        if spans is not None:
            spans.begin("fragment.compute")
        t0 = time.perf_counter()
        out_cols, out_mask = fn(blocks)
        sync()
        stats.compute_s += time.perf_counter() - t0
        if spans is not None:
            spans.end()
            spans.begin("fragment.download")
        result = to_numpy(Block(dict(out_cols), out_mask))
        if spans is not None:
            spans.end()

    # 2b. Semi-join kill before partitioning: the program emitted a
    # per-row Bloom verdict (``__bloom_pass``), or — for multi-column /
    # non-integer keys — the host probes the filter directly. Either way
    # the count is exact against the predicate-surviving stream, and the
    # killed rows never reach the exchange write.
    if spans is not None:
        spans.begin("fragment.host")
    if "__bloom_pass" in result:
        hit = result.pop("__bloom_pass") != 0
        stats.semijoin_killed = int(hit.size - hit.sum())
        if stats.semijoin_killed:
            result = {c: v[hit] for c, v in result.items()}
    elif sj is not None and all(c in result for c in sj["key"]):
        filt = bloomlib.bloom_from_wire(sj)
        ku = bloomlib.keys_u32(result, list(sj["key"]), filt["mode"])
        hit = bloomlib.bloom_probe_np(ku, filt["words"], filt["bits"],
                                      filt["k"])
        stats.semijoin_killed = int(hit.size - hit.sum())
        if stats.semijoin_killed:
            result = {c: v[hit] for c, v in result.items()}

    # 3. Final-stage host ops (global sort / limit on the compacted result).
    if spec["op"]["t"] == "final":
        fop = spec["op"]
        if fop["sort_keys"]:
            cols_for_sort = []
            for name, desc in reversed(fop["sort_keys"]):
                k = result[name]
                cols_for_sort.append(-k if desc else k)
            order = np.lexsort(cols_for_sort)
            result = {c: v[order] for c, v in result.items()}
        if fop.get("limit") is not None:
            result = {c: v[:fop["limit"]] for c, v in result.items()}
    if spans is not None:
        spans.end()

    # 4. Write deterministic output object(s).
    if spans is not None:
        spans.begin("fragment.write")
    schema = [pax.ColumnSpec(s["name"], s["kind"], s["dtype"])
              for s in spec["output"]["schema"]]
    names = [s.name for s in schema]
    result = {c: result[c].astype(np.dtype(s.dtype))
              for c, s in zip(names, schema)}
    part = spec["output"]["partitioning"]
    prefix = spec["output"]["prefix"]
    me = spec["fragment"]
    out_keys = []
    part_stats: list[dict] = []
    n_out = len(next(iter(result.values()))) if result else 0
    stats.rows_out = n_out
    if part["kind"] == "hash":
        # the exchange strategy owns the materialized layout: a direct
        # producer×partition grid, or one combined per-producer object
        # (combining / multi-level level 0)
        strat = exchange.get_strategy(part.get("strategy", "direct"))
        keys, part_stats = strat.write(store, result, schema, part,
                                       prefix, me, stats)
        out_keys.extend(keys)
    else:
        out = OutputHandler(store)
        out.append(result)
        key = f"{prefix}/f{me:04d}/out.spax"
        st = out.finish(key, schema)
        stats.account("table", st, write=True)
        out_keys.append(key)
        part_stats.append({"rows": n_out, "bytes": st.bytes, "kmv": [],
                           "write_s": st.sim_time_s})
    if spans is not None:
        spans.end(bytes=stats.bytes_written, rows=n_out)

    # 5. Build-side Bloom filter: fold this fragment's join-key column
    # into fleet-uniform filter words (size fixed by the coordinator so
    # per-fragment filters OR-merge). Emitted whenever the spec asks —
    # even when the planner's cost gate said no — so the Reoptimizer can
    # still adopt the filter at pilot-K time from observed cardinality.
    bloom_payload = None
    bl = spec.get("bloom")
    if bl is not None and part["kind"] == "hash" \
            and all(c in result for c in part["keys"]):
        if spans is not None:
            spans.begin("fragment.host")
        ku = bloomlib.keys_u32(result, list(part["keys"]), bl["mode"])
        words = bloomlib.bloom_build(ku, int(bl["bits"]), int(bl["k"]))
        bloom_payload = words.tobytes()
        if spans is not None:
            spans.end()
    return FragmentResult(out_keys, stats, part_stats,
                          bloom=bloom_payload)
