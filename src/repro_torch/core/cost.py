"""Cost model for serverless compute and storage (paper Tables 1 and 3).

Skyrise is cost-aware end-to-end: the optimizer sizes worker fleets and
picks shuffle tiers against these prices, and the evaluation (Fig. 6)
reports per-query dollars. Prices are AWS us-east-1, ARM Lambda, as used in
the paper's experiments (Aug 2024 – Jan 2025).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.storage.tiers import TIERS

# -- Table 1: compute -----------------------------------------------------------

# Lambda (ARM): 4.8 ¢/GiB-h at the largest sizes → ¢ per GiB-second.
LAMBDA_CENTS_PER_GIB_S = 4.8 / 3600.0
LAMBDA_CENTS_PER_REQUEST = 0.2 / 10_000.0       # $0.20 per 1M invocations
SQS_CENTS_PER_REQUEST = 0.4 / 10_000.0          # $0.40 per 1M requests

# EC2 (C6g) for comparison benchmarks: 1.7 ¢/GiB-h.
EC2_CENTS_PER_GIB_S = 1.7 / 3600.0

# Exchange-strategy switch hysteresis, shared by the planner's pick and
# the Reoptimizer's barrier re-pick: a non-default strategy must save at
# least this many cents AND this fraction of the baseline's cents.
EXCHANGE_MIN_SAVING_CENTS = 0.002
EXCHANGE_HYSTERESIS = 0.15

# Pipelined execution: fraction of post-first-batch read time a worker
# hides behind kernel compute by double-buffering (prefetch the next
# top-up batch while the kernel chews the previous one). 1.0 would be
# perfect overlap; the residue models prefetch ramp + final-batch drain.
PIPELINE_OVERLAP_EFFICIENCY = 0.9

# -- Table 2: startup latency [seconds] -------------------------------------------

LAMBDA_COLD_START = {"min": 0.122, "max": 0.451, "avg": 0.185}
LAMBDA_WARM_START = {"min": 0.005, "max": 0.009, "avg": 0.006}
EC2_COLD_START = {"min": 12.795, "max": 22.817, "avg": 15.226}
EC2_WARM_START = {"min": 9.810, "max": 19.288, "avg": 11.512}


@dataclasses.dataclass
class CostBreakdown:
    compute_cents: float = 0.0
    invoke_cents: float = 0.0
    messaging_cents: float = 0.0
    storage_request_cents: float = 0.0
    storage_transfer_cents: float = 0.0

    @property
    def total_cents(self) -> float:
        return (self.compute_cents + self.invoke_cents
                + self.messaging_cents + self.storage_request_cents
                + self.storage_transfer_cents)

    def merge(self, other: "CostBreakdown") -> None:
        self.compute_cents += other.compute_cents
        self.invoke_cents += other.invoke_cents
        self.messaging_cents += other.messaging_cents
        self.storage_request_cents += other.storage_request_cents
        self.storage_transfer_cents += other.storage_transfer_cents


@dataclasses.dataclass(frozen=True)
class ExchangeCost:
    """Projected cost/latency of one hash exchange under a strategy."""

    strategy: str
    tier: str
    puts: int                 # objects written (exchange + merge wave)
    gets: int                 # data + footer reads to consume it once
    merge_workers: int        # extra wave injected by the strategy
    request_cents: float
    transfer_cents: float
    worker_cents: float       # merge invocations + fleets' wait GiB-s
    makespan_s: float         # request-pool makespan across the barrier

    @property
    def cents(self) -> float:
        return self.request_cents + self.transfer_cents + self.worker_cents

    @property
    def requests(self) -> int:
        return self.puts + self.gets


class CostModel:
    """Charges workers (GiB-s + invocations + queue messages) and storage
    requests/transfers per tier."""

    def __init__(self, worker_memory_gib: float = 2.0):
        self.worker_memory_gib = worker_memory_gib

    def worker_cost(self, runtime_s: float,
                    tier_ops: dict) -> CostBreakdown:
        out = CostBreakdown()
        out.compute_cents = (runtime_s * self.worker_memory_gib
                             * LAMBDA_CENTS_PER_GIB_S)
        out.invoke_cents = LAMBDA_CENTS_PER_REQUEST
        # one response message to the coordinator's queue (send+receive)
        out.messaging_cents = 2 * SQS_CENTS_PER_REQUEST
        for tier_name, ops in tier_ops.items():
            tier = TIERS.get(tier_name, TIERS["s3-standard"])
            out.storage_request_cents += (
                ops["get"] * tier.read_request_cents_per_1m / 1e6
                + ops["put"] * tier.write_request_cents_per_1m / 1e6)
            out.storage_transfer_cents += (
                ops["bytes_read"] / 2**30 * tier.read_transfer_cents_per_gib
                + ops["bytes_written"] / 2**30
                * tier.write_transfer_cents_per_gib)
        return out

    def hedge_timeout_s(self, tier) -> float:
        """Cost-optimal hedged-read timeout for one storage tier.

        A duplicate GET costs one read request; waiting costs the
        worker's GiB-seconds. The break-even wait — where the dollars
        burned waiting equal the dollars a hedge would cost — is
        ``read_request_cents / (memory_gib · LAMBDA_CENTS_PER_GIB_S)``.
        Hedging any earlier pays more in requests than the wait costs;
        any later burns compute on the first-byte tail the measurement
        study documents. Offset from the tier's *median* read latency so
        a typical request never hedges (≈ 42 ms for s3-standard).
        """
        t = TIERS[tier] if isinstance(tier, str) else tier
        break_even_s = (t.read_request_cents_per_1m / 1e6) / (
            self.worker_memory_gib * LAMBDA_CENTS_PER_GIB_S)
        return t.read_median_s + break_even_s

    def coordinator_cost(self, runtime_s: float) -> CostBreakdown:
        out = CostBreakdown()
        out.compute_cents = (runtime_s * self.worker_memory_gib
                             * LAMBDA_CENTS_PER_GIB_S)
        out.invoke_cents = LAMBDA_CENTS_PER_REQUEST
        return out

    # -- exchange strategy costing (exec.exchange) -----------------------------
    def exchange_cost(self, producers: int, n_dest: int, nbytes: float, *,
                      strategy: str = "direct",
                      tier: str = "s3-standard",
                      pool_size: int = 16) -> "ExchangeCost":
        """Projected cost of materializing + reading one hash exchange
        under a shuffle strategy: per-request and transfer cents, the
        merge wave's worker charges, the GiB-seconds every fleet spends
        waiting on the exchange's request-pool makespans, and that
        makespan itself (the latency the strategy adds to the query).
        """
        from repro_torch.exec.exchange import get_strategy
        strat = get_strategy(strategy)
        t = TIERS.get(tier, TIERS["s3-standard"])
        P, D = max(producers, 1), max(n_dest, 1)
        G = strat.merge_workers(P)
        puts = strat.written_objects(P, D)
        # each object's footer is fetched once (2 requests) through the
        # shared cache; every object is read in full exactly once
        data_gets = strat.consumer_requests(P, D) + (P if G else 0)
        gets = data_gets + 2 * puts
        request_cents = (puts * t.write_request_cents_per_1m / 1e6
                         + gets * t.read_request_cents_per_1m / 1e6)
        hops = 2 if G else 1          # multi-level moves the bytes twice
        transfer_cents = hops * nbytes / 2**30 * (
            t.read_transfer_cents_per_gib + t.write_transfer_cents_per_gib)

        def wave(reqs_per_worker: float, latency_s: float,
                 bytes_per_worker: float) -> float:
            if reqs_per_worker <= 0:
                return 0.0
            return (math.ceil(reqs_per_worker / pool_size) * latency_s
                    + bytes_per_worker / t.bandwidth_bytes_per_s)

        write_wave = wave(strat.producer_puts(D), t.write_median_s,
                          nbytes / P)
        merge_wave = 0.0
        if G:
            merge_wave = (wave(3 * math.ceil(P / G), t.read_median_s,
                               nbytes / G)
                          + wave(D, t.write_median_s, nbytes / G))
        read_wave = wave(data_gets / D, t.read_median_s, nbytes / D)
        makespan_s = write_wave + merge_wave + read_wave
        wait_s = P * write_wave + G * merge_wave + D * read_wave
        worker_cents = (G * (LAMBDA_CENTS_PER_REQUEST
                             + 2 * SQS_CENTS_PER_REQUEST)
                        + wait_s * self.worker_memory_gib
                        * LAMBDA_CENTS_PER_GIB_S)
        return ExchangeCost(strategy, tier, puts, gets, G, request_cents,
                            transfer_cents, worker_cents, makespan_s)

    def choose_exchange_strategy(
            self, producers: int, n_dest: int, nbytes: float, *,
            tier_for, latency_budget_s: float | None = None,
            allowed: tuple[str, ...] | None = None,
            min_saving_cents: float = EXCHANGE_MIN_SAVING_CENTS,
            hysteresis: float = EXCHANGE_HYSTERESIS,
    ) -> tuple["ExchangeCost", dict[str, "ExchangeCost"]]:
        """Pick the dollar-minimal strategy whose request-pool makespan
        fits the latency budget (no budget → cents only). ``tier_for``
        maps a written-object count to a storage tier (the planner's
        hot-shuffle rule) or is a fixed tier name. The bit-compatible
        ``direct`` grid keeps ties: another strategy must save at least
        ``min_saving_cents`` *and* ``hysteresis`` of direct's cents.
        """
        from repro_torch.exec.exchange import get_strategy
        names = allowed or ("direct", "combining", "multilevel")
        costs: dict[str, ExchangeCost] = {}
        for name in names:
            strat = get_strategy(name)
            g = strat.merge_workers(producers)
            if g and g >= max(producers, 1):
                continue              # degenerate merge wave (√P ≥ P)
            tier = tier_for(strat.written_objects(producers, n_dest)) \
                if callable(tier_for) else tier_for
            costs[name] = self.exchange_cost(
                producers, n_dest, nbytes, strategy=name, tier=tier)
        pool = [c for c in costs.values()
                if latency_budget_s is None
                or c.makespan_s <= latency_budget_s] or list(costs.values())
        best = min(pool, key=lambda c: (c.cents, c.makespan_s))
        direct = costs.get("direct")
        if best.strategy != "direct" and direct is not None \
                and direct in pool:
            saving = direct.cents - best.cents
            if saving < max(min_saving_cents, hysteresis * direct.cents):
                best = direct
        return best, costs

    # -- semi-join filter pushdown (kernels.bloom) -------------------------------
    def semijoin_benefit(self, *, producers: int, n_dest: int,
                         probe_bytes: float, match_fraction: float,
                         build_distinct: int,
                         strategy: str = "direct",
                         tier: str = "s3-standard") -> dict:
        """Projected saving of pushing a build-side Bloom filter below a
        probe-side exchange, in cents.

        A filter kills the probe rows that cannot find a join partner
        *before* they are partitioned, so the exchange moves only the
        kept fraction ``match + fpr·(1 − match)`` of the payload (the
        false-positive residue is still shuffled and then dropped by the
        exact join). Against that saving stands the filter overhead: the
        build fleet's hash+publish work, one KV round-trip of the merged
        words per probe producer, and the probe fleet's k-hash membership
        test over its scan output. Monotone by construction: the benefit
        never decreases when ``match_fraction`` drops or ``probe_bytes``
        grows, so calibrated selectivities move the gate predictably.

        Returns ``{"benefit_cents", "kept_fraction", "fpr", "bits",
        "saved_cents", "overhead_cents"}``; the caller gates on
        ``benefit_cents > 0``.
        """
        from repro_torch.kernels.bloom import bloom_bits_for, bloom_fpr
        match = min(max(float(match_fraction), 0.0), 1.0)
        nbytes = max(float(probe_bytes), 0.0)
        bits = bloom_bits_for(max(int(build_distinct), 1))
        fpr = bloom_fpr(max(int(build_distinct), 1), bits)
        kept = min(1.0, match + fpr * (1.0 - match))
        full = self.exchange_cost(producers, n_dest, nbytes,
                                  strategy=strategy, tier=tier)
        filtered = self.exchange_cost(producers, n_dest, nbytes * kept,
                                      strategy=strategy, tier=tier)
        saved = full.cents - filtered.cents

        kv = TIERS["dynamodb"]
        words_bytes = bits / 8.0
        P = max(producers, 1)
        # publish: the build coordinator lands the merged words once in
        # the KV manifest; fetch: every probe producer's spec carries the
        # words (one KV read's worth of request + transfer each)
        publish_cents = (kv.write_request_cents_per_1m / 1e6
                         + kv.storage_cost_cents(int(words_bytes), 60.0))
        fetch_cents = P * (kv.read_request_cents_per_1m / 1e6
                           + words_bytes / kv.bandwidth_bytes_per_s
                           * self.worker_memory_gib
                           * LAMBDA_CENTS_PER_GIB_S)
        # probe-side membership test: k gathers over the VMEM-resident
        # words, memory-bound at roughly the scan bandwidth
        hash_s = nbytes / 1e9
        hash_cents = (hash_s * self.worker_memory_gib
                      * LAMBDA_CENTS_PER_GIB_S)
        overhead = publish_cents + fetch_cents + hash_cents
        return {"benefit_cents": saved - overhead,
                "kept_fraction": kept, "fpr": fpr, "bits": bits,
                "saved_cents": saved, "overhead_cents": overhead}

    # -- express-tier l0 intermediates (exec.exchange multilevel) ----------------
    def l0_tier_choice(self, producers: int, nbytes: float, *,
                       ttl_s: float = 60.0,
                       base_tier: str = "s3-standard") -> str:
        """Storage tier for a multilevel exchange's l0 intermediates.

        l0 objects live only from the producer write to the merge wave's
        read — the engine deletes the prefix once the wave lands, so the
        at-rest charge is prorated over ``ttl_s``, not a month. Each l0
        object is written once and read once (plus two footer reads), so
        the express tier's cheaper request halves and doubled bandwidth
        usually beat its 7× at-rest price for these short-lived objects;
        the comparison below keeps that honest when the intermediates
        are large or the wave is slow.
        """
        P = max(producers, 1)
        nbytes = max(float(nbytes), 0.0)

        def leg_cents(tier_name: str) -> float:
            t = TIERS.get(tier_name, TIERS["s3-standard"])
            reqs = (P * t.write_request_cents_per_1m
                    + 3 * P * t.read_request_cents_per_1m) / 1e6
            transfer = nbytes / 2**30 * (t.read_transfer_cents_per_gib
                                         + t.write_transfer_cents_per_gib)
            wait_s = 2 * nbytes / t.bandwidth_bytes_per_s
            compute = (wait_s * self.worker_memory_gib
                       * LAMBDA_CENTS_PER_GIB_S)
            return (reqs + transfer + compute
                    + t.storage_cost_cents(int(nbytes), ttl_s))

        express = leg_cents("s3-express")
        base = leg_cents(base_tier)
        return "s3-express" if express < base else base_tier

    # -- cost-optimal fleet sizing (adaptive re-optimization) -------------------
    def fleet_latency_s(self, n_workers: int, nbytes: int, *,
                        bandwidth_bytes_per_s: float = 90e6,
                        fixed_s: float = 0.05) -> float:
        """Projected pipeline latency with ``n_workers`` sharing
        ``nbytes`` of input: per-worker startup/dispatch overhead plus
        its byte share over one storage connection."""
        share = nbytes / max(n_workers, 1)
        return fixed_s + share / bandwidth_bytes_per_s

    def fleet_cost_cents(self, n_workers: int, nbytes: int, *,
                         bandwidth_bytes_per_s: float = 90e6,
                         fixed_s: float = 0.05) -> float:
        """Projected fleet dollars: per-worker fixed charges (invoke +
        response messages + startup compute) plus the byte-proportional
        scan compute, which is invariant in the fleet size. Strictly
        increasing in ``n_workers`` — parallelism buys latency, never
        dollars."""
        per_worker = (LAMBDA_CENTS_PER_REQUEST + 2 * SQS_CENTS_PER_REQUEST
                      + fixed_s * self.worker_memory_gib
                      * LAMBDA_CENTS_PER_GIB_S)
        scan_s = nbytes / bandwidth_bytes_per_s
        return (n_workers * per_worker
                + scan_s * self.worker_memory_gib * LAMBDA_CENTS_PER_GIB_S)

    def optimal_fleet(self, nbytes: int, *, latency_budget_s: float,
                      max_workers: int,
                      bandwidth_bytes_per_s: float = 90e6,
                      fixed_s: float = 0.05,
                      memory_fill_fraction: float = 0.5) -> int:
        """Dollar-minimal fleet size subject to a latency budget.

        ``fleet_cost_cents`` is strictly increasing and
        ``fleet_latency_s`` strictly decreasing in the worker count, so
        the cost-optimal feasible fleet is the *smallest* one whose
        projected latency fits the budget — computed in closed form —
        with two floors: every worker's input share must fit the
        function's memory budget, and the fleet never exceeds
        ``max_workers`` (quota / partition granularity); if the budget
        is unreachable even at ``max_workers``, latency wins and the cap
        is returned.
        """
        max_workers = max(1, max_workers)
        span = latency_budget_s - fixed_s
        if span <= 0:
            w = max_workers
        else:
            w = math.ceil(nbytes / (span * bandwidth_bytes_per_s))
        mem_budget = self.worker_memory_gib * 2**30 * memory_fill_fraction
        w = max(w, math.ceil(nbytes / max(mem_budget, 1)), 1)
        return min(w, max_workers)

    # -- pipelined overlap accounting --------------------------------------------
    @staticmethod
    def overlapped_io_s(total_io_s: float, first_batch_s: float,
                        efficiency: float = PIPELINE_OVERLAP_EFFICIENCY
                        ) -> tuple[float, float]:
        """Effective I/O wall time for a double-buffered consumer, and
        the simulated seconds the overlap saved.

        The first batch is always exposed (nothing to overlap against);
        of the remaining ``total_io_s - first_batch_s`` read time, the
        overlap efficiency's share hides behind kernel compute. Returns
        ``(effective_io_s, saved_s)``.
        """
        first = min(max(first_batch_s, 0.0), max(total_io_s, 0.0))
        rest = max(total_io_s - first, 0.0)
        saved = efficiency * rest
        return total_io_s - saved, saved

    @staticmethod
    def pipeline_admission_fraction(completions_s: list[float], *,
                                    topup_overhead_s: float = 0.01,
                                    efficiency: float =
                                    PIPELINE_OVERLAP_EFFICIENCY) -> float:
        """Cost-model-chosen consumer admission fraction k/n.

        For each candidate k, the expected consumer finish is the k-th
        producer completion (the admission wait), plus the overlap
        residue of the producer tail it still has to read — the
        ``1 - efficiency`` share of the spread ``c[n-1] - c[k-1]`` a
        double-buffered consumer cannot hide — plus a per-top-up
        overhead for the ``n - k`` partitions drained after launch
        (one mostly-hidden ranged GET: about a tier first-byte
        latency, so ~0.01 s). Skewed fleets (stragglers) admit early
        to hide the tail; exactly-uniform fleets admit late, where the
        k-statistic is the same instant anyway and top-ups are pure
        overhead. An empty completion list (no observations yet)
        falls back to 0.5, the pre-cost-model constant.
        """
        c = sorted(float(x) for x in completions_s or [])
        n = len(c)
        if n == 0:
            return 0.5
        best_k, best_cost = n, None
        for k in range(1, n + 1):
            cost = (c[k - 1]
                    + (1.0 - efficiency) * (c[-1] - c[k - 1])
                    + topup_overhead_s * (n - k))
            if best_cost is None or cost < best_cost - 1e-12:
                best_k, best_cost = k, cost
        return best_k / n

    @staticmethod
    def pipeline_start_offset_s(completions_s: list[float],
                                fraction: float) -> float:
        """When a consumer pipeline may start: the k-th order statistic
        of its producers' completion times, k = ⌈fraction · n⌉ — i.e.
        the moment the admission gate's partition fraction is met. An
        empty producer list (cache hits) starts immediately."""
        if not completions_s:
            return 0.0
        k = max(1, math.ceil(fraction * len(completions_s)))
        return sorted(completions_s)[k - 1]

    @staticmethod
    def stage_latency_budget(deadline_s: float, elapsed_s: float,
                             stages_left: int,
                             floor_s: float = 1e-3) -> float:
        """Per-stage latency budget from a query-level SLO deadline.

        The remaining deadline (simulated seconds) is split evenly over
        the stages still to run. A query running *behind* its deadline
        gets the floor — a near-zero budget that drives
        ``optimal_fleet`` to the cap, i.e. a missed deadline escalates
        the fleet instead of giving up.
        """
        remaining = deadline_s - elapsed_s
        return max(remaining, floor_s) / max(stages_left, 1)
