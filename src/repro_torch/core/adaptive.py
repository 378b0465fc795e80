"""Runtime re-optimization at pipeline barriers (paper sections 3.2/3.3).

The paper's core claim is that a serverless query processor stays
competitive only through *adaptive and cost-aware* techniques: compile-time
estimates decide how a pipeline would run, but every decision downstream of
a stage barrier can be re-made once upstream pipelines have actually run.
Workers emit per-partition output statistics (rows, bytes, distinct-key KMV
sketches) into the exchange manifest (the registry entry published per
pipeline); before the engine launches a downstream pipeline, the
:class:`Reoptimizer` replaces the planner's guesses with those observations:

  * **fleet re-sizing** — the fragment count is re-derived by minimizing
    ``CostModel`` dollars subject to a latency budget
    (``CostModel.optimal_fleet``) over the *observed* exchange bytes,
    instead of the static ``-(-est_bytes // bytes_per_worker)``; upstream
    partitions are re-assigned to the smaller fleet LPT-balanced by bytes;
  * **empty-partition pruning** — partitions the manifest proves empty are
    dropped from every fragment's read set (and from the fleet-size cap);
  * **broadcast-join downgrade** — a repartition join whose *observed*
    build side fits a worker's memory budget switches the build source to
    a broadcast (mode=all) read, freeing the fleet size from build-side
    partition alignment;
  * **exchange re-tiering** — the pipeline's own output exchange tier is
    re-picked from the adapted producer count (object-request-rate
    reasoning of section 3.4).

All re-decisions mutate only ``Pipeline.params`` (the mutable execution
half of the plan); the logical core — and therefore the semantic hash —
is untouched, so adapted pipelines still cache and dedup against their
statically planned twins. Partition re-assignment is only applied when
every aligned (partition-mode) source shares one hash layout, and
assigning whole upstream partitions to fragments preserves co-location of
join keys and group keys, so results stay identical to the static plan.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cost import CostModel
from repro_torch.exec.operators import kmv_estimate, kmv_merge  # noqa: F401
from repro_torch.sql.physical import Pipeline


@dataclasses.dataclass
class _Leaf:
    op: dict
    under_build: bool


def _collect_leaves(op: dict, under_build: bool = False) -> list[_Leaf]:
    """All scan_exchange leaves of a fragment op tree, flagged when they
    sit on the build side of a join (build rows never *drive* output:
    a partition with zero probe rows produces nothing)."""
    out: list[_Leaf] = []
    if op.get("t") == "scan_exchange":
        out.append(_Leaf(op, under_build))
        return out
    for k in ("child", "probe"):
        if k in op:
            out.extend(_collect_leaves(op[k], under_build))
    if "build" in op:
        out.extend(_collect_leaves(op["build"], True))
    return out


def apply_broadcast(op: dict, sources: list[str]) -> dict:
    """Copy of ``op`` with the given exchange sources read broadcast
    (mode=all) instead of partition-aligned — the shuffle→broadcast join
    downgrade. The original op tree (the immutable logical core) is
    never mutated."""
    if not sources:
        return op
    out = dict(op)
    if out.get("t") == "scan_exchange" and out.get("source") in sources \
            and out.get("mode") == "partition":
        out["mode"] = "all"
    for k in ("child", "probe", "build"):
        if k in out:
            out[k] = apply_broadcast(out[k], sources)
    return out


def _lpt_assignment(parts: list[int], weights: dict[int, float],
                    n_fragments: int) -> list[list[int]]:
    """Assign upstream partitions to fragments, longest-processing-time
    first (balance observed weights); each fragment's list stays sorted
    so read/concat order is deterministic."""
    buckets: list[list[int]] = [[] for _ in range(n_fragments)]
    loads = [0.0] * n_fragments
    for d in sorted(parts, key=lambda d: (-weights.get(d, 0.0), d)):
        i = loads.index(min(loads))
        buckets[i].append(d)
        loads[i] += weights.get(d, 0.0)
    return [sorted(b) for b in buckets]


def straggler_skew_weights(bytes_per_part: dict[int, float],
                           write_s_per_part: dict[int, float],
                           cap: float = 4.0) -> dict[int, float]:
    """LPT weights inflated by observed runtime skew.

    The manifest carries each partition's observed write latency; a
    partition that took disproportionately long *per byte* sits on slow
    storage (hot key, throttled prefix) and will likely read slowly too.
    Its weight is inflated by the latency-per-byte ratio against the
    fleet median (clipped to ``cap``), so the LPT assignment gives slow
    partitions dedicated workers instead of byte-balanced bundles.
    """
    rates = {d: write_s_per_part.get(d, 0.0) / max(b, 1.0)
             for d, b in bytes_per_part.items() if b > 0}
    positive = sorted(r for r in rates.values() if r > 0)
    if not positive:
        return dict(bytes_per_part)
    med = positive[len(positive) // 2]
    if med <= 0:
        return dict(bytes_per_part)
    out = {}
    for d, b in bytes_per_part.items():
        skew = min(max(rates.get(d, 0.0) / med, 1.0), cap)
        out[d] = b * skew
    return out


class Reoptimizer:
    """Re-derives a pipeline's execution parameters from the observed
    statistics of its upstream exchange manifests."""

    def __init__(self, cost_model: CostModel, *,
                 latency_budget_s: float = 2.0,
                 broadcast_bytes: int = 16 << 20,
                 hot_shuffle_object_threshold: int = 64,
                 quota: int = 2500,
                 forced_strategy: str | None = None,
                 straggler_skew_cap: float = 4.0):
        self.cost_model = cost_model
        self.latency_budget_s = latency_budget_s
        self.broadcast_bytes = broadcast_bytes
        self.hot_shuffle_object_threshold = hot_shuffle_object_threshold
        self.quota = quota
        # a planner-forced exchange strategy is never re-picked
        self.forced_strategy = forced_strategy
        self.straggler_skew_cap = straggler_skew_cap

    # -- entry point --------------------------------------------------------
    def adapt(self, p: Pipeline, sources: dict[str, dict], *,
              latency_budget_s: float | None = None,
              fleet_cap: int | None = None) -> list[dict]:
        """Re-optimize ``p`` in place (mutating ``p.params`` only) before
        launch; returns the list of adaptation records applied.

        ``sources`` maps source semantic hashes to their registry
        entries (the exchange manifests). Pipelines that scan base
        tables directly have no runtime observations to exploit and are
        left untouched; so is any pipeline whose manifests predate stat
        emission (graceful fallback to the static plan).

        ``latency_budget_s`` overrides the configured budget for this
        call — the service tier passes the query's *remaining deadline
        share* here, so a query running behind its SLO escalates to a
        bigger fleet at the next barrier. ``fleet_cap`` clamps the fleet
        (budget-exhausted tenants degrade to their minimum fleet).
        """
        if p.scan_units or not sources:
            return []
        adaptations: list[dict] = []
        leaves = _collect_leaves(p.op)
        budget = self.latency_budget_s if latency_budget_s is None \
            else latency_budget_s

        self._downgrade_broadcast_joins(p, sources, adaptations)
        self._prune_empty_partitions(p, sources, leaves, adaptations)
        self._resize_fleet(p, sources, leaves, adaptations,
                           latency_budget_s=budget, fleet_cap=fleet_cap)
        self._replan_exchange(p, sources, adaptations,
                              latency_budget_s=budget)
        return adaptations

    # -- (c) shuffle → broadcast join downgrade ------------------------------
    def _downgrade_broadcast_joins(self, p: Pipeline, sources: dict,
                                   adaptations: list[dict]) -> None:
        def walk(op: dict) -> None:
            if op.get("t") == "join":
                build = op.get("build", {})
                if build.get("t") == "scan_exchange" \
                        and build.get("mode") == "partition":
                    sem = build["source"]
                    st = (sources.get(sem) or {}).get("stats") or {}
                    nbytes = st.get("bytes_out")
                    if nbytes is not None \
                            and nbytes <= self.broadcast_bytes:
                        p.params.broadcast_sources.append(sem)
                        adaptations.append({
                            "kind": "broadcast_downgrade", "source": sem,
                            "observed_bytes": int(nbytes),
                            "budget_bytes": int(self.broadcast_bytes)})
            for k in ("child", "probe", "build"):
                if k in op:
                    walk(op[k])
        walk(p.op)

    # -- (b) empty-partition pruning ----------------------------------------
    def _prune_empty_partitions(self, p: Pipeline, sources: dict,
                                leaves: list[_Leaf],
                                adaptations: list[dict]) -> None:
        for leaf in leaves:
            sem = leaf.op["source"]
            entry = sources.get(sem) or {}
            part = entry.get("partitioning") or {}
            rows = (entry.get("stats") or {}).get("partition_rows")
            if part.get("kind") != "hash" or rows is None \
                    or sem in p.params.source_partitions \
                    or entry.get("partial"):
                # partial (pilot-K) manifests cannot prove a partition
                # empty — producers still in flight may yet fill it
                continue
            nonempty = [d for d, r in enumerate(rows) if r > 0]
            if len(nonempty) < len(rows):
                p.params.source_partitions[sem] = nonempty
                adaptations.append({
                    "kind": "partition_prune", "source": sem,
                    "pruned": len(rows) - len(nonempty),
                    "of": len(rows)})

    # -- (a) cost-optimal fleet re-sizing -------------------------------------
    def _resize_fleet(self, p: Pipeline, sources: dict,
                      leaves: list[_Leaf],
                      adaptations: list[dict], *,
                      latency_budget_s: float | None = None,
                      fleet_cap: int | None = None) -> None:
        budget = self.latency_budget_s if latency_budget_s is None \
            else latency_budget_s
        aligned = [l for l in leaves
                   if l.op.get("mode") == "partition"
                   and l.op["source"] not in p.params.broadcast_sources]
        if not aligned:
            return
        entries = []
        for leaf in aligned:
            entry = sources.get(leaf.op["source"])
            part = (entry or {}).get("partitioning") or {}
            st = (entry or {}).get("stats") or {}
            if part.get("kind") != "hash" \
                    or st.get("partition_rows") is None \
                    or st.get("partition_bytes") is None:
                return          # manifest without stats: stay static
            entries.append((leaf, part, st))
        n_dests = {part["n_dest"] for _, part, _ in entries}
        if len(n_dests) != 1:
            return              # cached foreign layouts cannot align
        D = n_dests.pop()
        # a partition drives output when any non-build source has rows
        driving_rows = [0] * D
        bytes_per_part: dict[int, float] = {d: 0.0 for d in range(D)}
        write_s_per_part: dict[int, float] = {d: 0.0 for d in range(D)}
        for leaf, part, st in entries:
            write_s = st.get("partition_write_s") or [0.0] * D
            for d in range(D):
                bytes_per_part[d] += st["partition_bytes"][d]
                write_s_per_part[d] += write_s[d]
                if not leaf.under_build:
                    driving_rows[d] += st["partition_rows"][d]
        if not any(not leaf.under_build for leaf, _, _ in entries):
            driving_rows = [1] * D      # defensive: no driving source
        if any(entry.get("partial")
               for leaf, _, _ in entries
               for entry in [sources.get(leaf.op["source"]) or {}]):
            # pilot-K estimates: a partition with no rows in the pilot
            # subset may still be filled by in-flight producers — every
            # partition must stay assigned or its rows would be dropped
            driving_rows = [max(r, 1) for r in driving_rows]
        nonempty = [d for d in range(D) if driving_rows[d] > 0]
        total_bytes = int(sum(bytes_per_part[d] for d in nonempty))

        f0 = p.params.n_fragments
        cap = min(f0, max(len(nonempty), 1), self.quota)
        if fleet_cap is not None:
            cap = min(cap, max(fleet_cap, 1))
        w = self.cost_model.optimal_fleet(
            total_bytes, latency_budget_s=budget,
            max_workers=cap)
        static_map = (w == f0 == D and len(nonempty) == D
                      and not p.params.broadcast_sources)
        if static_map:
            return              # the 1:1 fragment↔partition map stands
        # straggler-aware assignment: inflate LPT weights of partitions
        # whose observed write latency per byte is far above the median,
        # so slow storage partitions get dedicated workers
        weights = straggler_skew_weights(bytes_per_part, write_s_per_part,
                                         cap=self.straggler_skew_cap)
        p.params.partition_assignment = _lpt_assignment(
            nonempty, weights, w)
        p.params.n_fragments = w
        if w != f0:
            adaptations.append({
                "kind": "fleet_resize", "from": f0, "to": w,
                "observed_bytes": total_bytes,
                "est_bytes": int(p.params.est_in_bytes),
                "cost_cents": self.cost_model.fleet_cost_cents(
                    w, total_bytes),
                "latency_budget_s": budget})

    # -- (d) exchange re-plan: strategy + tier --------------------------------
    def _observed_out_bytes(self, p: Pipeline, sources: dict) -> float:
        """Best runtime estimate of this pipeline's own exchange payload:
        the planner's figure, rescaled by how far the observed input
        bytes diverged from the estimated input bytes."""
        est = float(max(p.params.est_out_bytes, 0))
        est_in = float(p.params.est_in_bytes)
        obs_in = sum(float((e.get("stats") or {}).get("bytes_out", 0))
                     for e in sources.values())
        if est_in > 0 and obs_in > 0:
            # rescale downward only: growing the figure could talk the
            # re-pick into a costlier strategy on a noisy observation
            est = min(est, est * obs_in / est_in)
        return est

    def _replan_exchange(self, p: Pipeline, sources: dict,
                         adaptations: list[dict], *,
                         latency_budget_s: float | None = None) -> None:
        """Re-pick this pipeline's output shuffle strategy and tier from
        the adapted producer count and recalibrated payload estimate —
        including injecting (or cancelling) the multi-level merge wave
        the engine schedules after the producer fleet."""
        from repro_torch.exec.exchange import get_strategy
        budget = self.latency_budget_s if latency_budget_s is None \
            else latency_budget_s
        part = p.params.partitioning
        if part.kind != "hash":
            return
        producers = p.params.n_fragments
        if self.forced_strategy is None:
            nbytes = self._observed_out_bytes(p, sources)
            cost, costs = self.cost_model.choose_exchange_strategy(
                producers, part.n_dest, nbytes,
                tier_for=self._tier_for_objects,
                latency_budget_s=budget,
            )
            cur = costs.get(part.strategy)
            switch = cost.strategy != part.strategy
            if switch and cur is not None \
                    and cur.makespan_s <= budget:
                # hysteresis against churn: keep the planner's strategy
                # unless the re-pick saves real money (or the current
                # one blows the latency budget)
                from repro_torch.core.cost import (EXCHANGE_HYSTERESIS,
                                             EXCHANGE_MIN_SAVING_CENTS)
                saving = cur.cents - cost.cents
                if saving < max(EXCHANGE_MIN_SAVING_CENTS,
                                EXCHANGE_HYSTERESIS * cur.cents):
                    switch = False
            if switch:
                old = part.strategy
                old_est = p.params.est_exchange_requests
                part.strategy = cost.strategy
                adaptations.append({
                    "kind": "exchange_restrategy",
                    "from": old, "to": cost.strategy,
                    "est_requests_from": old_est,
                    "est_requests_to": get_strategy(
                        cost.strategy).producer_requests(producers,
                                                         part.n_dest),
                    "cents_from": cur.cents if cur else -1.0,
                    "cents_to": cost.cents})
        strat = get_strategy(part.strategy)
        # refresh the request estimate for the (possibly resized) fleet
        p.params.est_exchange_requests = strat.producer_requests(
            producers, part.n_dest)
        objects = strat.written_objects(producers, part.n_dest)
        tier = self._tier_for_objects(objects)
        if tier != part.tier:
            adaptations.append({"kind": "exchange_retier",
                                "from": part.tier, "to": tier,
                                "shuffle_objects": objects})
            part.tier = tier
        # multilevel l0 intermediates are short-lived (deleted after the
        # merge wave) — re-route them to the express tier when cheaper
        if part.strategy == "multilevel":
            part.l0_tier = self.cost_model.l0_tier_choice(
                producers, self._observed_out_bytes(p, sources),
                base_tier=part.tier)
        else:
            part.l0_tier = None

    def _tier_for_objects(self, objects: int) -> str:
        return "s3-express" if objects > self.hot_shuffle_object_threshold \
            else "s3-standard"

    # -- (e) semi-join filter adopt/revoke ------------------------------------
    def semijoin_decision(self, p: Pipeline, *, build_rows: float,
                          build_distinct: int | None = None
                          ) -> dict | None:
        """Re-gate a probe pipeline's semi-join filter from the observed
        build-side cardinality (a pilot-K extrapolation or the sealed
        manifest's exact figures).

        Called by the engine outside :meth:`adapt` — the probe is a scan
        pipeline, which ``adapt`` leaves untouched. Mutates only
        ``params.semijoin``; the probe's sem hash already folds the build
        side, so flipping the verdict never splits the result cache.
        Returns the adaptation record (``semijoin_adopt`` /
        ``semijoin_revoke``) or None if the plan-time verdict stands.
        """
        from repro_torch.core.cost import EXCHANGE_MIN_SAVING_CENTS
        sj = p.params.semijoin
        if not sj:
            return None
        base = float(sj.get("base_rows") or 0.0)
        match = min(1.0, build_rows / base) if base > 0 \
            else float(sj["est_match"])
        distinct = int(build_distinct) if build_distinct \
            else max(int(build_rows), 1)
        part = p.params.partitioning
        ben = self.cost_model.semijoin_benefit(
            producers=p.params.n_fragments, n_dest=part.n_dest,
            probe_bytes=float(max(p.params.est_out_bytes, 0)),
            match_fraction=match, build_distinct=distinct,
            strategy=part.strategy, tier=part.tier)
        # adopting mid-flight must clear the same churn guard as an
        # exchange re-pick; revoking only needs the benefit to vanish
        want = ben["benefit_cents"] > 0 if sj["enabled"] \
            else ben["benefit_cents"] > EXCHANGE_MIN_SAVING_CENTS
        if want == sj["enabled"]:
            return None
        sj["enabled"] = want
        sj["est_match"] = match
        sj["est_distinct"] = distinct
        return {"kind": "semijoin_adopt" if want else "semijoin_revoke",
                "build_rows": int(build_rows),
                "build_distinct": distinct,
                "match_fraction": round(match, 4),
                "benefit_cents": ben["benefit_cents"]}
