"""Serverless query-worker function (the Lambda handler, section 3.3).

Deserializes the invocation payload into a fragment plan, executes it, and
returns the response message the coordinator polls from its queue: result
location plus execution statistics used for adaptive behavior and billing.

One handler is shared by every fragment of a session (the "code package"),
so the SPAX footer cache it owns is session-scoped: F fragments scanning G
partitions parse each footer once per object version.
"""

from __future__ import annotations

from repro_torch.core.cost import PIPELINE_OVERLAP_EFFICIENCY, CostModel
from repro_torch.exec.batch import resolve_device
from repro_torch.exec.fragment import execute_fragment
from repro_torch.storage.io_handlers import FooterCache
from repro_torch.storage.object_store import ObjectStore


def make_worker_handler(store: ObjectStore,
                        footer_cache: FooterCache | None = None,
                        cost_model: CostModel | None = None,
                        device=None):
    # cost_model (optional): enables hedged reads — workers re-trigger
    # tail-latency GETs at the tier's break-even timeout instead of the
    # constant straggler timeout
    # device: where the fragments run — the card unless the caller asks
    # for the CPU (resolved once, so a CPU-only host fails here, early)
    device = resolve_device(device)
    cache = footer_cache if footer_cache is not None else FooterCache()

    def handler(payload: dict) -> tuple[dict, float]:
        result = execute_fragment(store, payload, footer_cache=cache,
                                  cost_model=cost_model, device=device)
        stats = result.stats
        if stats.pipelined:
            # Double-buffered consumption: only the first available
            # batch's read time is exposed; later top-up batches hide
            # behind kernel compute at the model's overlap efficiency.
            eff_io, saved = CostModel.overlapped_io_s(
                stats.sim_io_s, stats.first_input_s,
                PIPELINE_OVERLAP_EFFICIENCY)
            stats.overlap_saved_s = saved
            sim_runtime = eff_io + stats.compute_s
        else:
            sim_runtime = stats.sim_io_s + stats.compute_s
        response = {
            "fragment": payload["fragment"],
            "output_keys": result.output_keys,
            # per-destination (rows, bytes, distinct-key sketch) — the
            # exchange-manifest statistics the adaptive re-optimizer
            # consumes at the next stage barrier
            "partition_stats": result.partition_stats,
            # build-side semi-join filter shard (Bloom words) — the
            # coordinator OR-merges these across the fleet and publishes
            # the merged filter through the partial-manifest protocol
            "bloom": result.bloom,
            # a traced fragment's spans, on this worker's clock and
            # thread (the engine relays them to the session's observers)
            "spans": None if stats.spans is None else {
                "thread": stats.spans.thread, "rows": stats.spans.rows},
            "stats": {
                "rows_in": stats.rows_in,
                "rows_out": stats.rows_out,
                "sim_io_s": stats.sim_io_s,
                "compute_s": stats.compute_s,
                "requests": stats.requests,
                "retriggers": stats.retriggers,
                "bytes_read": stats.bytes_read,
                "bytes_written": stats.bytes_written,
                "footer_cache_hits": stats.footer_cache_hits,
                "kernel": stats.kernel,
                "tier_ops": stats.tier_ops,
                "pipelined": stats.pipelined,
                "first_input_s": stats.first_input_s,
                "topups": stats.topups,
                "overlap_saved_s": stats.overlap_saved_s,
                "semijoin_killed": stats.semijoin_killed,
            },
        }
        return response, sim_runtime

    handler.footer_cache = cache
    handler.device = device
    return handler
