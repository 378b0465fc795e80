"""Per-query execution engine (paper sections 3.1, 3.3).

One ``QueryEngine`` manages the lifecycle of exactly one query: it
compiles SQL to pipelines, schedules them stage-wise by dependency,
invokes one worker function per fragment (two-level √W fan-out for large
fleets), tracks worker progress, and adapts:

  * stragglers → re-triggered mid-query (safe: workers are idempotent and
    write deterministic single objects; racing duplicates overwrite
    identical results);
  * transient infrastructure failures → bounded retries; on repeated
    failure the fragment's input units are *reassigned to more workers*;
  * deterministic (code/data) failures → abort; completed pipelines stay
    registered, so a re-run restarts from the last complete stage
    (stage results are checkpoints);
  * completed pipelines are registered in the result cache under their
    semantic hash and skipped by later queries (section 3.4);
  * *in-flight* pipelines are claimed in the registry, so a concurrent
    query wanting the same semantic hash blocks on the one running
    execution (claim/publish/await_complete) instead of racing it.

A pipeline's fragments execute concurrently in wall-clock on the
platform's thread pool. Admission is per *fragment slot*: each fragment
holds exactly one quota slot for exactly its own lifetime, so a finished
worker's slot is instantly available to any fragment of any query — no
wave barrier on the slowest worker.

Engines are cheap and stateless between queries: everything they need is
in the catalog, the registry, and the object store. A ``SkyriseSession``
(``repro_torch.api``) runs many engines concurrently against one shared
``FaasPlatform``; fragments — *across* queries, not just within one
pipeline — are admitted through the platform's ``AdmissionController``
so the fleet never exceeds the function-concurrency quota.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
import uuid
from typing import Callable

import numpy as np

from repro_torch.core.adaptive import Reoptimizer, apply_broadcast
from repro_torch.core.cost import CostBreakdown, CostModel
from repro_torch.core.events import QueryObserver
from repro_torch.core.platform import (AdmissionController, FaasPlatform,
                                 InvocationResult)
from repro_torch.core.registry import ResultRegistry
from repro_torch.core.retry import (QueryFailedError, RetryBudget,
                              RetryBudgetExhausted, RetryPolicy,
                              TransientInfraError, is_transient)
from repro_torch.core.worker import make_worker_handler
from repro_torch.data.catalog import Catalog
from repro_torch.exec import exchange
from repro_torch.exec.operators import kmv_estimate, kmv_merge
from repro_torch.sql.calibration import (SelectivityCalibration,
                                   scan_filter_signature)
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import (PhysicalPlan, Pipeline, PlannerConfig,
                                compile_query)
from repro_torch.sql.rules import optimize
from repro_torch.storage.io_handlers import InputHandler
from repro_torch.storage.object_store import ObjectStore


class QueryAborted(QueryFailedError):
    """Permanent query failure with a post-mortem (bad plan, repeated
    deterministic worker failure, missing upstream)."""

    def __init__(self, msg: str, post_mortem: dict):
        super().__init__(msg)
        self.post_mortem = post_mortem


class QueryCancelled(RuntimeError):
    """Raised inside the engine when the owning handle was cancelled."""


@dataclasses.dataclass
class PipelineReport:
    pid: int
    sem_hash: str
    n_fragments: int               # fragments actually invoked
    cache_hit: bool = False
    deduped: bool = False    # in-flight dedup: shared a peer's execution
    attempts: int = 0
    stragglers_retriggered: int = 0
    transient_failures: int = 0
    reassignments: int = 0
    sim_s: float = 0.0
    rows_out: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    requests: int = 0
    # kernel dispatch + metadata-cache visibility (section 3.3/3.4 hot path)
    kernel: str = ""               # fused kernel the plan lowers to
    kernel_fragments: int = 0      # fragments that ran on the fused path
    kernel_miss_reason: str = ""   # why the matcher fell back (if it did)
    kernel_roofline: dict | None = None   # roofline-chosen tiling
    footer_cache_hits: int = 0
    # adaptive re-optimization (core.adaptive): the static plan's fleet,
    # the planner's row estimate (EXPLAIN ANALYZE est vs actual), the
    # barrier decisions applied, and the per-partition output manifest
    # accumulated from worker responses
    n_planned: int = 0
    est_rows: int = -1
    adaptations: list = dataclasses.field(default_factory=list)
    partition_stats: list | None = None
    # exchange subsystem (exec.exchange): the shuffle strategy this
    # pipeline's output exchange ran under, its estimated vs observed
    # producer-side storage requests, and the injected merge-wave width
    exchange_strategy: str = ""
    est_exchange_requests: int = 0
    exchange_requests: int = 0
    merge_fragments: int = 0
    # barrier-free pipelined execution: whether this pipeline consumed
    # partial upstream manifests, how many producers' stats seeded its
    # re-optimization (pilot-K), the sim time of its first available
    # input batch, the top-up batches drained after launch, and the read
    # time hidden behind kernel compute (double-buffering)
    pipelined: bool = False
    pilot_k: int = 0
    first_input_s: float = 0.0
    topups: int = 0
    overlap_saved_s: float = 0.0
    # semi-join filter pushdown: the decision record of an annotated
    # probe pipeline (plan annotation + runtime verdict + ``applied``),
    # the probe rows the filter killed before partitioning, and — build
    # side — the merged Bloom filter wire dict OR-accumulated from the
    # fleet's responses and published with the exchange manifest
    semijoin: dict | None = None
    semijoin_killed: int = 0
    semijoin_bloom: dict | None = None
    # the pipeline's window on the query's simulated timeline, and the
    # per-fragment completion offsets downstream admission gates key on
    sim_start_s: float = 0.0
    sim_end_s: float = 0.0
    dispatch_s: float = 0.0
    producer_completions: list = dataclasses.field(default_factory=list)
    # recompute cost of this pipeline alone — the registry's age×cost
    # eviction keep-score
    cost_cents: float = 0.0


@dataclasses.dataclass
class QueryStats:
    sim_latency_s: float = 0.0
    wall_s: float = 0.0
    pipelines: list[PipelineReport] = dataclasses.field(default_factory=list)
    cost: CostBreakdown = dataclasses.field(default_factory=CostBreakdown)
    query_id: str = ""

    @property
    def cache_hits(self) -> int:
        return sum(1 for p in self.pipelines if p.cache_hit)


@dataclasses.dataclass
class QueryResult:
    locations: list[str]
    output_names: list[str]
    stats: QueryStats

    @property
    def location(self) -> str:
        """First result object (back-compat; see ``locations``)."""
        return self.locations[0]

    def fetch(self, store: ObjectStore) -> dict[str, np.ndarray]:
        """Read and concatenate all result fragments, in fragment order."""
        ih = InputHandler(store)
        parts = [ih.read_table(loc)[0] for loc in self.locations]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}


@dataclasses.dataclass
class CoordinatorConfig:
    planner: PlannerConfig = dataclasses.field(default_factory=PlannerConfig)
    straggler_detect_factor: float = 3.0
    straggler_min_timeout_s: float = 0.5
    max_attempts: int = 3
    two_level_threshold: int = 16
    response_poll_overhead_s: float = 0.01
    use_result_cache: bool = True
    # Adaptive re-optimization at stage barriers (core.adaptive): re-size
    # downstream fleets cost-optimally under the latency budget, prune
    # empty exchange partitions, downgrade shuffle joins to broadcast
    # when the observed build side fits the memory budget (None → the
    # planner's broadcast threshold), and re-pick exchange tiers.
    adaptive: bool = True
    adaptive_latency_budget_s: float = 2.0
    broadcast_downgrade_bytes: int | None = None
    # Persist observed per-(table, predicate) selectivities in the KV
    # tier and seed the planner's estimates with them (downward-only),
    # so recurring predicates converge without waiting for a barrier.
    calibrate_selectivity: bool = True
    # Barrier-free pipelined execution (incremental exchange manifests):
    # every pipeline runs on its own scheduler thread; a consumer
    # launches once the admission fraction of each upstream fleet's
    # partitions has landed *and* that fleet is fully submitted (the
    # deadlock-freedom gate), tops up as later manifests arrive, and
    # re-optimizes on the first `pilot_k` producers' observed stats
    # extrapolated to the fleet. `pipelined=False` restores the
    # bit-compatible all-or-nothing stage-barrier schedule.
    # `pipeline_start_fraction=None` (the default) lets the cost model
    # choose the fraction per upstream fleet from its observed runtime
    # skew (CostModel.pipeline_admission_fraction); a float forces that
    # constant fraction everywhere, e.g. the seed behavior's 0.5.
    pipelined: bool = True
    pipeline_start_fraction: float | None = None
    pilot_k: int = 2
    pipelined_wait_timeout_s: float = 600.0
    # Scan-selectivity pilot: an uncalibrated scan→filter pipeline with
    # at least this many scan units probes one unit first and records
    # the observed selectivity before the fleet launches.
    pilot_scan_min_units: int = 4
    # Unified retry policy (core.retry): bounded exponential backoff
    # with full jitter, one per-query budget spent by every layer that
    # retries a transient failure (fragment re-invokes and query-level
    # re-drives after coordinator-side infrastructure errors).
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    # Hedged storage reads: replace the constant straggler re-trigger
    # timeout with the cost model's per-tier break-even point (duplicate
    # request cents vs GiB-seconds spent waiting). Off by default —
    # identical request counts to the seed behavior.
    hedged_reads: bool = False
    # Semi-join filter pushdown: build fleets of planner-annotated
    # repartition joins construct a Bloom filter over the join key and
    # publish the merged words through the partial-manifest protocol;
    # eligible probe pipelines wait (bounded) for the *sealed* filter
    # and kill non-matching rows before partitioning. A partial filter
    # is never applied — missing producers would mean false negatives.
    # Off → annotated plans run unfiltered (sem hashes are identical
    # either way, so both settings share the result cache).
    semijoin: bool = True
    semijoin_wait_timeout_s: float = 30.0


class QueryEngine:
    """Executes one query against session-shared infrastructure.

    ``registry``/``handler`` default to private instances (standalone
    use); a session passes its shared ones so the result cache and the
    worker code are shared across queries.
    """

    def __init__(self, store: ObjectStore, catalog: Catalog, *,
                 platform: FaasPlatform | None = None,
                 config: CoordinatorConfig | None = None,
                 cost_model: CostModel | None = None,
                 registry: ResultRegistry | None = None,
                 handler=None,
                 observer: QueryObserver | None = None,
                 query_id: str = "query",
                 cancel_check: Callable[[], None] | None = None,
                 priority: int = 0,
                 tenant: str | None = None,
                 deadline_s: float | None = None,
                 fleet_cap: int | None = None):
        self.store = store
        self.catalog = catalog
        self.platform = platform or FaasPlatform()
        self.config = config or CoordinatorConfig()
        self.cost_model = cost_model or CostModel()
        self.registry = registry or ResultRegistry(store)
        self.handler = handler or make_worker_handler(store)
        self.observer = observer or QueryObserver()
        self.query_id = query_id
        self.priority = priority
        # service tier (repro_torch.service): tenant → fair-share admission
        # group; deadline_s → per-stage latency budgets (SLO-aware fleet
        # sizing); fleet_cap → degraded dispatch for over-budget tenants
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.fleet_cap = fleet_cap
        # pipelines run on concurrent scheduler threads (pipelined mode),
        # each with its own stage budget; a failing pipeline poisons its
        # siblings through _sibling_abort so their waits unwind fast
        self._budget_local = threading.local()
        self._sibling_abort: BaseException | None = None
        # per-plan admission gates: sem_hash -> {"event", "floor"} —
        # a pipelined consumer may not consult the registry for a
        # source this plan itself produces until its producer thread
        # has committed (cache hit, or streams reset for execution)
        self._source_gates: dict[str, dict] = {}
        # sem_hash -> this execution's name for it in the registry and
        # the store (_execution_names); empty while the result cache is on
        self._exec_names: dict[str, str] = {}
        self._cancel_check = cancel_check
        self.admission: AdmissionController = self.platform.admission
        cfg = self.config
        self.calibration = SelectivityCalibration(store) \
            if cfg.calibrate_selectivity else None
        self.reoptimizer = Reoptimizer(
            self.cost_model,
            latency_budget_s=cfg.adaptive_latency_budget_s,
            broadcast_bytes=(cfg.broadcast_downgrade_bytes
                             if cfg.broadcast_downgrade_bytes is not None
                             else cfg.planner.broadcast_threshold_bytes),
            hot_shuffle_object_threshold=(
                cfg.planner.hot_shuffle_object_threshold),
            quota=self.admission.quota,
            forced_strategy=cfg.planner.exchange_strategy)
        # per-query transient-retry allowance shared by every retrying
        # layer (fragment re-invokes, query-level re-drives)
        self.retry_budget = RetryBudget(self.config.retry.budget)
        # fragments of one pipeline report concurrently
        self._metrics_lock = threading.Lock()

    # -- public API ----------------------------------------------------------
    def plan_sql(self, sql: str) -> PhysicalPlan:
        stmt = parse(sql)
        lqp, _ = Binder(self.catalog).bind(stmt)
        lqp = optimize(lqp)
        return compile_query(lqp, self.catalog, self.config.planner,
                             cost_model=self.cost_model,
                             calibration=self.calibration)

    def execute_sql(self, sql: str) -> QueryResult:
        return self.execute_plan(self.plan_sql(sql))

    def execute_plan(self, plan: PhysicalPlan) -> QueryResult:
        """Run the plan, re-driving it after coordinator-side transient
        infrastructure failures (registry/ledger/KV write lost
        mid-protocol, chaos kills). Re-driving is safe: completed
        pipelines are published checkpoints (cache hits on the re-drive)
        and abandoned claims are re-won or TTL-stolen. Retries draw from
        the per-query budget; exhaustion (or ``query_retries`` attempts)
        surfaces :class:`RetryBudgetExhausted` with the final transient
        cause chained."""
        policy = self.config.retry
        q_attempt = 0
        while True:
            try:
                return self._execute_plan_once(plan)
            except QueryCancelled:
                raise
            except TransientInfraError as e:
                if not is_transient(e):
                    raise
                q_attempt += 1
                if q_attempt > policy.query_retries \
                        or not self.retry_budget.try_spend():
                    raise RetryBudgetExhausted(
                        f"query {self.query_id}: transient infrastructure "
                        f"failures exhausted the retry budget "
                        f"(spent {self.retry_budget.spent}, last: {e})",
                        last_error=e,
                        spent=self.retry_budget.spent) from e
                time.sleep(policy.backoff_s(q_attempt))

    def _execute_plan_once(self, plan: PhysicalPlan) -> QueryResult:
        self._exec_names = self._execution_names(plan)
        if self.config.pipelined:
            return self._execute_plan_pipelined(plan)
        t_wall = time.perf_counter()
        stats = QueryStats(query_id=self.query_id)
        stages = plan.stages()
        for si, stage in enumerate(stages):
            if self.deadline_s is not None:
                # remaining deadline split over the stages still to run:
                # a query running behind its SLO gets a shrinking budget
                # → optimal_fleet escalates toward the cap at the barrier
                self._stage_budget_s = self.cost_model.stage_latency_budget(
                    self.deadline_s, stats.sim_latency_s,
                    len(stages) - si)
            stage_sim = 0.0
            for pid in _stage_order(plan, stage):
                self._check_cancel()
                report = self._run_pipeline(plan.pipelines[pid], stats)
                stats.pipelines.append(report)
                stage_sim = max(stage_sim, report.sim_s)
            stats.sim_latency_s += stage_sim
        stats.wall_s = time.perf_counter() - t_wall
        stats.cost.merge(
            self.cost_model.coordinator_cost(stats.sim_latency_s))
        root = plan.pipelines[plan.root_pid]
        return QueryResult(self._result_locations(root),
                           plan.output_names, stats)

    def _execute_plan_pipelined(self, plan: PhysicalPlan) -> QueryResult:
        """Barrier-free schedule: every pipeline gets its own scheduler
        thread immediately; consumers block inside ``_resolve_sources``
        on their upstream partial manifests (the admission gate) instead
        of on a stage barrier, then top up as later partitions land.

        A failing pipeline poisons its own partial streams (in-flight
        consumer workers fail fast) and trips ``_sibling_abort`` so
        sibling threads unwind at their next cancel check; the first
        *root-cause* error (in pipeline order) is re-raised."""
        t_wall = time.perf_counter()
        stats = QueryStats(query_id=self.query_id)
        stages = plan.stages()
        self._sibling_abort = None
        self._source_gates = {
            p.sem_hash: {"event": threading.Event(), "floor": None}
            for p in plan.pipelines.values()}
        # deterministic per-pipeline budget: the deadline split evenly
        # over all stages up front — there is no barrier-elapsed feedback
        # to re-split on when every stage is in flight at once
        budget = None
        if self.deadline_s is not None:
            budget = self.cost_model.stage_latency_budget(
                self.deadline_s, 0.0, max(len(stages), 1))
        order = [pid for stage in stages for pid in stage]
        reports: dict[int, PipelineReport] = {}
        errors: dict[int, BaseException] = {}

        def run(pid: int) -> None:
            p = plan.pipelines[pid]
            try:
                self._stage_budget_s = budget
                reports[pid] = self._run_pipeline(p, stats)
            except BaseException as e:
                errors[pid] = e
                self._sibling_abort = e

        threads = [threading.Thread(target=run, args=(pid,), daemon=True,
                                    name=f"{self.query_id}-p{pid}")
                   for pid in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._sibling_abort = None
        if errors:
            for pid in order:    # prefer a root cause over induced aborts
                err = errors.get(pid)
                if err is not None and not isinstance(err, QueryCancelled):
                    raise err
            raise errors[next(pid for pid in order if pid in errors)]
        for pid in order:
            stats.pipelines.append(reports[pid])
        self._sim_timeline(plan, stages, reports, stats)
        stats.wall_s = time.perf_counter() - t_wall
        stats.cost.merge(
            self.cost_model.coordinator_cost(stats.sim_latency_s))
        root = plan.pipelines[plan.root_pid]
        return QueryResult(self._result_locations(root),
                           plan.output_names, stats)

    def _admission_fraction(self, completions_s: list[float]) -> float:
        """The consumer-admission fraction for one upstream fleet: the
        config's forced constant when set, else the cost model's pick
        from the fleet's observed completion skew."""
        f = self.config.pipeline_start_fraction
        if f is not None:
            return f
        return self.cost_model.pipeline_admission_fraction(completions_s)

    def _sim_timeline(self, plan: PhysicalPlan, stages: list[list[int]],
                      reports: dict[int, PipelineReport],
                      stats: QueryStats) -> None:
        """Simulated-makespan post-pass for the pipelined schedule: a
        consumer starts not at its slowest producer's finish (the
        barrier) but at the admission fraction's k-th order statistic of
        each upstream fleet's simulated completions — and cannot finish
        before the producers whose tail partitions it still reads."""
        end: dict[int, float] = {}
        sem_pid = {p.sem_hash: pid for pid, p in plan.pipelines.items()}
        for stage in stages:
            for pid in _stage_order(plan, stage):
                r = reports[pid]
                start = 0.0
                tail = 0.0
                for dep in plan.pipelines[pid].deps:
                    rr = reports[dep]
                    if rr.cache_hit:
                        continue
                    if r.pipelined:
                        frac = self._admission_fraction(
                            rr.producer_completions)
                        avail = (rr.sim_start_s + rr.dispatch_s
                                 + CostModel.pipeline_start_offset_s(
                                     rr.producer_completions, frac))
                        start = max(start, min(avail, end[dep]))
                    else:
                        start = max(start, end[dep])
                    tail = max(tail, end[dep])
                # a filtered probe waited for the build's sealed filter
                # — the build pipeline is not a dep, but it is on the
                # probe's critical path (stage order processes filter
                # producers first, so its end is already known)
                if r.semijoin is not None and r.semijoin.get("applied"):
                    bpid = sem_pid.get(r.semijoin.get("build"))
                    if bpid is not None and bpid in end \
                            and not reports[bpid].cache_hit:
                        start = max(start, end[bpid])
                r.sim_start_s = start
                r.sim_end_s = max(start + r.sim_s, tail) \
                    if not r.cache_hit else start
                end[pid] = r.sim_end_s
        stats.sim_latency_s = max(end.values()) if end else 0.0

    # -- execution names ------------------------------------------------------
    def _execution_names(self, plan: PhysicalPlan) -> dict[str, str]:
        """With the result cache off no claim dedupes two live runs of
        one pipeline, so each execution names its plan's pipelines
        ``{sem_hash}@{query_id}-{run}`` wherever it writes or reads
        their results: the result prefix, the partial streams, the
        registry entry and the upstream lookups. Sharing the semantic
        hash there let two runs that sized their fleets apart read each
        other's objects. ``run`` is fresh for every drive of the plan,
        so two processes over one store (or a re-drive) never collide.
        With the cache on the semantic hash is the name: a claim lets
        one run execute and the others share its result."""
        if self.config.use_result_cache:
            return {}
        run = uuid.uuid4().hex[:8]
        return {p.sem_hash: f"{p.sem_hash}@{self.query_id}-{run}"
                for p in plan.pipelines.values()}

    def _name(self, sem: str) -> str:
        """This execution's registry and store name for ``sem``; a source
        the plan does not produce keeps its semantic hash."""
        return self._exec_names.get(sem, sem)

    # -- result location ------------------------------------------------------
    def _result_locations(self, root: Pipeline) -> list[str]:
        """Resolve the root pipeline's objects from its registry entry.

        The registered layout is authoritative: a cache hit may have been
        produced under a *different* physical configuration (fragment
        count) than the current plan — semantic hashing guarantees only
        logical equivalence (section 3.4).
        """
        name = self._name(root.sem_hash)
        entry = self.registry.lookup(name)
        if entry is not None:
            prefix, n = entry["prefix"], entry["n_fragments"]
        else:  # cache disabled + nothing registered (defensive)
            prefix, n = f"results/{name}", root.n_fragments
        return [f"{prefix}/f{f:04d}/out.spax" for f in range(n)]

    # -- pipeline scheduling ----------------------------------------------------
    @property
    def _stage_budget_s(self) -> float | None:
        """Per-stage latency budget, thread-local: in pipelined mode
        concurrent pipeline threads carry different budgets."""
        return getattr(self._budget_local, "value", None)

    @_stage_budget_s.setter
    def _stage_budget_s(self, value: float | None) -> None:
        self._budget_local.value = value

    def _check_cancel(self) -> None:
        if self._cancel_check is not None:
            self._cancel_check()
        if self._sibling_abort is not None:
            raise QueryCancelled("sibling pipeline failed; aborting")

    def _run_pipeline(self, p: Pipeline, stats: QueryStats) -> PipelineReport:
        report = PipelineReport(p.pid, p.sem_hash, p.n_fragments,
                                kernel=p.kernel or "",
                                kernel_miss_reason=p.kernel_miss_reason
                                or "",
                                kernel_roofline=p.kernel_roofline,
                                n_planned=p.n_fragments,
                                est_rows=p.params.est_out_rows)
        claimed = False
        if self.config.use_result_cache:
            # claim/publish/await_complete: exactly one of N concurrent
            # queries wanting this sem_hash executes it; the rest block
            # on the in-flight entry and share the published result.
            while True:
                if self.registry.lookup(p.sem_hash):
                    report.cache_hit = True
                    self._open_source_gate(p.sem_hash)
                    self.observer.on_pipeline_complete(self.query_id,
                                                       report)
                    return report
                if self.registry.claim(p.sem_hash):
                    claimed = True
                    break
                entry = self.registry.await_complete(
                    p.sem_hash, cancel_check=self._check_cancel)
                if entry is not None:
                    report.cache_hit = True
                    report.deduped = True
                    self._open_source_gate(p.sem_hash)
                    self.observer.on_pipeline_complete(self.query_id,
                                                       report)
                    return report
                # the owner abandoned (failed/cancelled) → try to claim
        try:
            return self._execute_pipeline(p, stats, report)
        except BaseException:
            if self.config.pipelined \
                    and (claimed or not self.config.use_result_cache):
                # poison the partial streams *before* abandoning the
                # claim: a waiter that re-claims resets them fresh in
                # begin_partial, so abort-then-abandon cannot poison the
                # new owner's streams — the reverse order could
                self.registry.abort_partial(self._name(p.sem_hash))
            if claimed:
                self.registry.abandon(p.sem_hash)
            raise

    def _execute_pipeline(self, p: Pipeline, stats: QueryStats,
                          report: PipelineReport) -> PipelineReport:
        name = self._name(p.sem_hash)
        prefix = f"results/{name}"
        cfg = self.config
        pipelined = cfg.pipelined
        sources = self._resolve_sources(p.op, pipelined=pipelined)
        partials = [e for e in sources.values() if e.get("partial")]
        if partials:
            report.pipelined = True
            report.pilot_k = max(e["partial"]["pilot_k"] for e in partials)

        # Barrier hook: every physical decision downstream of this
        # barrier is re-evaluated against the observed statistics the
        # upstream manifests carry (fleet size, partition assignment,
        # join strategy, exchange tier). Mutates p.params only — the
        # semantic hash, and thus caching/dedup, is unaffected.
        if self.config.adaptive:
            adaptations = self.reoptimizer.adapt(
                p, sources, latency_budget_s=self._stage_budget_s,
                fleet_cap=self.fleet_cap)
            if adaptations:
                report.adaptations = adaptations
                report.n_fragments = p.n_fragments
                for a in adaptations:
                    self.observer.on_adaptation(self.query_id, p.pid, a)
        self._apply_slo_fleet(p, report)
        if pipelined:
            self._pilot_scan(p, report, stats)

        # Semi-join filter pushdown. Build side: instruct the fleet to
        # hash its exchange keys into per-fragment Bloom words (sized
        # here, after any pilot re-estimate, so every fragment — and
        # every straggler duplicate — agrees on the word count). Probe
        # side: resolve the build's sealed filter (bounded wait, runtime
        # adopt/revoke) and inject it into every fragment spec so rows
        # are killed before partitioning.
        bloom_spec = None
        if cfg.semijoin and p.params.bloom is not None:
            from repro_torch.kernels import bloom as bloomlib
            capacity = max(int(p.params.bloom.get("est_distinct") or 1),
                           int(p.params.est_out_rows), 1)
            bloom_spec = {"bits": bloomlib.bloom_bits_for(capacity),
                          "k": bloomlib.BLOOM_K,
                          "mode": p.params.bloom["mode"]}
        semijoin_spec = self._semijoin_filter(p, report, stats) \
            if cfg.semijoin else None

        if p.partitioning.kind == "hash":
            report.exchange_strategy = p.partitioning.strategy
            report.est_exchange_requests = \
                p.params.est_exchange_requests
        self.observer.on_pipeline_start(self.query_id, p.pid, p.sem_hash,
                                        p.n_fragments)
        # broadcast-downgraded sources rewrite the op tree on one copy
        # (the pipeline's logical core stays untouched); the rewritten
        # join probe re-enters kernel dispatch and, when the chain ends
        # in an aggregate, runs the fused join-probe kernel
        eff_op = apply_broadcast(p.op, p.params.broadcast_sources)
        specs = {
            f: self._fragment_spec(p, f, p.n_fragments, prefix, sources,
                                   eff_op, bloom=bloom_spec,
                                   semijoin=semijoin_spec)
            for f in range(p.n_fragments)
        }

        two_level = p.n_fragments >= cfg.two_level_threshold
        dispatch = self.platform.dispatch_time_s(p.n_fragments,
                                                 two_level=two_level)
        report.dispatch_s = dispatch
        extra_fragments: list[dict] = []

        part_dict = p.partitioning.to_dict()
        strat = None
        if p.partitioning.kind == "hash":
            strat = exchange.get_strategy(p.partitioning.strategy)
            # consumers dispatch on the *materialized* layout
            part_dict["layout"] = strat.layout
        # incremental manifests: open the stream consumers gate on
        # before any producer runs, so a consumer admitted mid-fleet
        # already sees the layout metadata
        wave = (pipelined and strat is not None
                and bool(strat.merge_workers(p.n_fragments)))
        merge_thread = None
        merge_box: dict = {}
        on_all_submitted = None
        if pipelined:
            floor = time.time()
            if wave:
                # multilevel producers stream into the l0 manifest; the
                # consumer-facing main stream is re-opened (with the
                # real group count) at wave launch — reset it here too
                # so a stale sealed manifest from an earlier run of
                # this sem cannot admit consumers in the meantime
                self.registry.begin_partial(
                    name, stream="l0", n_producers=p.n_fragments,
                    prefix=f"{prefix}/l0")
                self.registry.begin_partial(
                    name,
                    n_producers=exchange.merge_group_count(
                        p.n_fragments),
                    prefix=prefix, partitioning=part_dict,
                    schema=p.output_schema)
                merge_thread = threading.Thread(
                    target=self._merge_wave_pipelined,
                    args=(p, prefix, report, stats, merge_box),
                    daemon=True, name=f"{self.query_id}-p{p.pid}-merge")
            else:
                self.registry.begin_partial(
                    name, n_producers=p.n_fragments, prefix=prefix,
                    partitioning=part_dict, schema=p.output_schema)
            # producer committed to executing: admit consumers, but only
            # to entries published from here on (anything older is a
            # different run's layout)
            self._open_source_gate(p.sem_hash, floor)
            producer_stream = "l0" if wave else "partial"

            def on_all_submitted() -> None:
                # every producer now sits in the FIFO executor queue:
                # admit consumers (they then only ever wait on work
                # scheduled ahead of them — the deadlock-freedom gate)
                # and only now launch the merge wave, so its workers
                # also queue strictly behind the producers they drain
                self.registry.mark_all_submitted(
                    name, p.n_fragments, stream=producer_stream)
                if merge_thread is not None:
                    merge_thread.start()

        try:
            # The whole fleet runs concurrently in wall-clock; each
            # fragment holds one admission slot for exactly its own
            # lifetime (retries included), released on completion — so
            # concurrent queries interleave at fragment granularity, not
            # wave granularity. ``completions`` holds per-fragment
            # *runtimes*.
            results = self.platform.invoke_many(
                self.handler, list(specs.values()), pipeline=p.pid,
                cancel_check=self._check_cancel, priority=self.priority,
                group=self.tenant,
                run=lambda spec: self._run_fragment(p, spec, report,
                                                    stats,
                                                    extra_fragments),
                on_all_submitted=on_all_submitted)
            completions: dict[int, float] = {
                f: res.sim_runtime_s for f, res in zip(specs, results)}

            # Straggler mitigation: detect on per-fragment *runtimes*
            # (never on quota-wave-offset completion times — a later
            # wave's normal fragment is not a straggler) against the
            # fleet's fast quartile (the median is already contaminated
            # in small or straggler-heavy fleets), then re-trigger; the
            # effective runtime races the original against the duplicate
            # — safe because workers are idempotent single-object
            # writers.
            if len(completions) >= 2:
                runtimes = np.array(list(completions.values()))
                fast = float(np.percentile(runtimes, 25, method="lower"))
                threshold = max(cfg.straggler_detect_factor * fast,
                                cfg.straggler_min_timeout_s)
                for f, t in list(completions.items()):
                    if t > threshold:
                        self.observer.on_straggler(self.query_id, p.pid,
                                                   f)
                        self.admission.acquire(1, priority=self.priority,
                                               group=self.tenant)
                        try:
                            # the duplicate's rows/bytes repeat the
                            # original worker's output — bill its cost,
                            # don't double-count its payload
                            dup = self._invoke(
                                p, specs[f], report, stats,
                                attempt=100 + report.attempts,
                                count_payload=False)
                        finally:
                            self.admission.release(1)
                        report.stragglers_retriggered += 1
                        if dup.error is None:
                            completions[f] = min(t, threshold
                                                 + dup.sim_runtime_s)
        except BaseException:
            if pipelined:
                # fail fast: poison the streams so in-flight consumers
                # and the merge wave unwind instead of sitting out their
                # top-up timeout, then collect the wave thread
                self.registry.abort_partial(name)
                if merge_thread is not None:
                    merge_thread.join()
            raise

        report.sim_s += (dispatch
                         + self._sim_makespan(list(completions.values()))
                         + cfg.response_poll_overhead_s)
        report.producer_completions = self._sim_schedule(
            list(completions.values()))

        n_total = p.n_fragments + len(extra_fragments)
        publish_n = n_total
        if not pipelined and strat is not None \
                and strat.merge_workers(n_total):
            # multi-level (barrier): inject the merge wave as an extra
            # stage of this pipeline's schedule; the published exchange
            # is the wave's G×m grid, so downstream readers see G
            # producers
            publish_n = self._run_merge_wave(p, n_total, prefix,
                                             report, stats)
        if pipelined:
            try:
                if wave:
                    # seal l0 with the final producer count (splits
                    # included) so merge workers drain the tail and stop
                    # watching, then collect the concurrent wave
                    self.registry.finish_partial(
                        name, stream="l0", n_producers=n_total)
                    merge_thread.join()
                    err = merge_box.get("error")
                    if err is not None:
                        raise err
                    publish_n = merge_box["publish_n"]
                self.registry.finish_partial(name,
                                             n_producers=publish_n)
            except BaseException:
                self.registry.abort_partial(name)
                raise
        self._record_calibration(p, report)
        self.registry.publish(
            name, prefix=prefix, n_fragments=publish_n,
            partitioning=part_dict, schema=p.output_schema,
            stats=self._manifest_stats(report),
            cost_cents=report.cost_cents)
        self.observer.on_pipeline_complete(self.query_id, report)
        return report

    def _merge_wave_pipelined(self, p: Pipeline, prefix: str,
                              report: PipelineReport, stats: QueryStats,
                              box: dict) -> None:
        """Merge-wave launcher thread (pipelined multilevel exchange):
        waits until the admission fraction of l0 partitions has landed,
        then runs the wave *concurrently* with the producer tail — its
        workers top up straight from the l0 manifest."""
        try:
            gate = self._source_gates.get(p.sem_hash) or {}
            self.registry.await_source_ready(
                self._name(p.sem_hash),
                fraction=self.config.pipeline_start_fraction,
                cost_model=self.cost_model,
                stream="l0", cancel_check=self._check_cancel,
                timeout_s=self.config.pipelined_wait_timeout_s,
                min_published_at=gate.get("floor"))
            box["publish_n"] = self._run_merge_wave(
                p, p.n_fragments, prefix, report, stats, pipelined=True)
        except BaseException as e:      # surfaced after join
            box["error"] = e

    # -- SLO-aware scan-fleet sizing (service tier) ---------------------------
    def _apply_slo_fleet(self, p: Pipeline,
                         report: PipelineReport) -> None:
        """Re-size a *scan* pipeline's fleet against the query's
        per-stage deadline budget (scan pipelines have no upstream
        manifests, so the barrier reoptimizer skips them): a tight
        budget escalates toward one worker per scan unit, a loose one
        shrinks to the dollar-minimal fleet. ``fleet_cap`` (degraded
        tenant dispatch) clamps unconditionally."""
        if not p.scan_units:
            return
        if self._stage_budget_s is None and self.fleet_cap is None:
            return
        f0 = p.params.n_fragments
        cap = min(len(p.scan_units), self.admission.quota)
        if self.fleet_cap is not None:
            cap = min(cap, max(self.fleet_cap, 1))
        if self._stage_budget_s is not None:
            n = self.cost_model.optimal_fleet(
                int(p.input_bytes),
                latency_budget_s=self._stage_budget_s, max_workers=cap)
        else:
            n = min(f0, cap)
        if n == f0:
            return
        p.params.n_fragments = n
        report.n_fragments = n
        a = {"kind": "deadline_fleet", "from": f0, "to": n,
             "latency_budget_s": self._stage_budget_s,
             "fleet_cap": self.fleet_cap}
        report.adaptations = list(report.adaptations) + [a]
        self.observer.on_adaptation(self.query_id, p.pid, a)

    # -- multi-level exchange: injected merge wave ----------------------------
    COMBINE_GATE_FRACTION = 0.9

    def _combine_gate(self, report: PipelineReport) -> bool:
        """Per-worker partial aggregation in the merge wave pays off only
        when keys repeat: gate on the KMV sketches' estimated group/key
        cardinality vs the observed row count."""
        ps = report.partition_stats
        if not ps:
            return False
        rows = sum(s["rows"] for s in ps)
        if rows <= 0:
            return False
        distinct = kmv_estimate(kmv_merge([s["kmv"] for s in ps]))
        return distinct <= self.COMBINE_GATE_FRACTION * rows

    def _run_merge_wave(self, p: Pipeline, producers: int, prefix: str,
                        report: PipelineReport, stats: QueryStats, *,
                        pipelined: bool = False) -> int:
        """Run the multi-level exchange's merge wave: G = ⌈√producers⌉
        workers re-partition the producers' combined l0 intermediates
        into the final G×n_dest grid, re-combining mergeable
        partial-aggregate states when the KMV gate passes. Returns G
        (the published producer count).

        Barrier mode runs the wave serially after the producer fleet on
        the *barrier-drained* l0. Pipelined mode runs it concurrently
        with the producer tail: wave specs carry the l0 manifest key, so
        each merge worker starts on its group's available l0 objects and
        tops up until the stream seals."""
        cfg = self.config
        G = exchange.merge_group_count(producers)
        op = p.op["child"] if p.op.get("t") == "final" else p.op
        combine = exchange.combine_spec(op)
        if combine is not None:
            # pipelined: gated on whatever producer stats have landed so
            # far — a pilot estimate of key repetition (rows-identical
            # either way; combine only changes intermediate bytes)
            with self._metrics_lock:
                gate = self._combine_gate(report)
            if not gate:
                combine = None
        part = p.partitioning
        grid = {"kind": "hash", "keys": list(part.keys),
                "n_dest": part.n_dest, "tier": part.tier,
                "strategy": "direct"}
        mop_extra = {}
        on_all = None
        name = self._name(p.sem_hash)
        if pipelined:
            # the consumer-facing main stream: downstream admission
            # gates on the wave's G partitions, not the l0 producers
            self.registry.begin_partial(
                name, n_producers=G, prefix=prefix,
                partitioning=dict(p.partitioning.to_dict(),
                                  layout=exchange.get_strategy(
                                      part.strategy).layout),
                schema=p.output_schema)
            mop_extra = {
                "manifest_key": self.registry.partial_key(name, "l0"),
                "wait_timeout_s": cfg.pipelined_wait_timeout_s}

            def on_all() -> None:
                self.registry.mark_all_submitted(name, G)
        specs = [{
            "query_id": p.sem_hash, "pipeline": p.pid, "fragment": j,
            "n_fragments": G,
            "op": {"t": "merge_exchange", "l0_prefix": f"{prefix}/l0",
                   "producers": producers, "group": j, "n_groups": G,
                   "keys": list(part.keys), "n_dest": part.n_dest,
                   "combine": combine, "schema": p.output_schema,
                   "tier": part.tier, "l0_tier": part.l0_tier,
                   **mop_extra},
            "scan_units": [],
            "output": {"prefix": prefix, "partitioning": grid,
                       "schema": p.output_schema},
            "sources": {},
        } for j in range(G)]
        mreport = PipelineReport(p.pid, p.sem_hash, G)
        dispatch = self.platform.dispatch_time_s(
            G, two_level=G >= cfg.two_level_threshold)
        extra: list[dict] = []
        results = self.platform.invoke_many(
            self.handler, specs, pipeline=p.pid,
            cancel_check=self._check_cancel, priority=self.priority,
            group=self.tenant,
            run=lambda spec: self._run_fragment(p, spec, mreport, stats,
                                                extra),
            on_all_submitted=on_all)
        if pipelined:
            # the wave overlapped the producer tail: fold it into the
            # pipeline's sim window as a concurrent phase starting at
            # the l0 admission fraction, not a serial one. Safe to read
            # the producer figures here — wave workers only finish after
            # the l0 seal, which follows the producer accounting.
            start = CostModel.pipeline_start_offset_s(
                report.producer_completions,
                self._admission_fraction(report.producer_completions))
            sched = self._sim_schedule([r.sim_runtime_s
                                        for r in results])
            with self._metrics_lock:
                report.sim_s = max(
                    report.sim_s,
                    report.dispatch_s + start + dispatch + max(sched)
                    + cfg.response_poll_overhead_s)
                # downstream admission keys on the wave's completions
                report.producer_completions = [start + dispatch + t
                                               for t in sched]
        else:
            report.sim_s += (dispatch
                             + self._sim_makespan([r.sim_runtime_s
                                                   for r in results])
                             + cfg.response_poll_overhead_s)
        report.merge_fragments = G
        report.attempts += mreport.attempts
        report.transient_failures += mreport.transient_failures
        report.requests += mreport.requests
        report.bytes_read += mreport.bytes_read
        report.bytes_written += mreport.bytes_written
        report.exchange_requests += mreport.exchange_requests
        report.footer_cache_hits += mreport.footer_cache_hits
        report.cost_cents += mreport.cost_cents
        if mreport.pipelined:   # wave workers topped up from partial l0
            report.pipelined = True
            report.topups += mreport.topups
            report.overlap_saved_s += mreport.overlap_saved_s
        # the wave's grid is what consumers read: its observations
        # supersede the producers' l0 intermediates in the manifest
        report.rows_out = mreport.rows_out
        report.partition_stats = mreport.partition_stats
        if part.l0_tier:
            # express-tier l0 intermediates are billed at-rest until
            # deleted: the wave has drained them, so enforce the TTL
            # now (object DELETEs are unbilled)
            self.store.delete_prefix(f"{prefix}/l0/")
        return G

    def _record_calibration(self, p: Pipeline,
                            report: PipelineReport) -> None:
        """Persist the observed selectivity of a pure scan→filter chain
        (cross-query calibration; see repro_torch.sql.calibration)."""
        if self.calibration is None or not p.scan_units:
            return
        if report.semijoin is not None and report.semijoin.get("applied"):
            # a pushed semi-join filter killed rows below the scan —
            # rows_out no longer reflects the predicate's selectivity
            return
        sig = scan_filter_signature(
            p.op["child"] if p.op.get("t") == "final" else p.op)
        if sig is None:
            return
        table, pred_key = sig
        base = self.catalog.table(table).rows
        if base > 0:
            self.calibration.record(table, pred_key,
                                    report.rows_out / base)

    def _publish_partial(self, p: Pipeline, spec: dict,
                         res: InvocationResult) -> None:
        """Stream one successful fragment's landed output (stats +
        layout) into the pipeline's partial manifest — the
        per-partition publish event that replaces the stage barrier.
        Multilevel producers stream into the l0 manifest (the merge
        wave's input); merge-wave fragments and everything else into the
        consumer-facing main stream."""
        if not self.config.pipelined or res.payload is None:
            return
        part = spec["output"]["partitioning"]
        stream = "partial"
        if spec["op"].get("t") != "merge_exchange" \
                and part.get("kind") == "hash" \
                and exchange.get_strategy(part["strategy"]).merge_workers(
                    spec["n_fragments"]):
            stream = "l0"
        s = res.payload["stats"]
        ps = res.payload.get("partition_stats") or []
        info = {"rows": s["rows_out"], "bytes": s["bytes_written"],
                # producer wall time: the admission gate's cost model
                # reads the landed walls as a pilot of the fleet's skew
                "wall_s": float(res.sim_runtime_s),
                "partition_rows": [d["rows"] for d in ps],
                "partition_bytes": [d["bytes"] for d in ps],
                "partition_write_s": [float(d.get("write_s", 0.0))
                                      for d in ps]}
        if res.payload.get("bloom") is not None:
            # semi-join filter shard: this producer's Bloom words plus
            # its distinct-key sketch, streamed through the partial
            # manifest so a probe can merge the sealed filter (and pilot
            # the cost gate) without waiting for the complete entry
            info["bloom"] = res.payload["bloom"]
            info["distinct_kmv"] = [int(x) for x in kmv_merge(
                [d["kmv"] for d in ps])] if ps else []
        n = None
        if spec["fragment"] >= spec["n_fragments"]:
            n = spec["fragment"] + 1    # reassignment split grew the fleet
        self.registry.publish_partial(self._name(p.sem_hash),
                                      spec["fragment"], info,
                                      stream=stream, n_producers=n)

    def _pilot_scan(self, p: Pipeline, report: PipelineReport,
                    stats: QueryStats) -> None:
        """Scan-selectivity pilot (pipelined mode): before an
        *uncalibrated* scan→filter fleet launches, probe one scan unit
        into a scratch prefix, record the observed selectivity in the
        cross-query calibration store, and correct the row estimate the
        stage was planned on. The probe is throwaway — its rows are not
        counted (the fleet re-reads its unit), only its cost and sim
        time are billed — and best-effort: on failure the fleet simply
        runs on the static estimate."""
        cfg = self.config
        if self.calibration is None or not cfg.adaptive \
                or not p.scan_units \
                or len(p.scan_units) < cfg.pilot_scan_min_units \
                or p.n_fragments < 2:
            return
        op = p.op["child"] if p.op.get("t") == "final" else p.op
        sig = scan_filter_signature(op)
        if sig is None:
            return
        table, pred_key = sig
        if self.calibration.lookup(table, pred_key) is not None:
            return                      # already calibrated: no probe
        spec = {
            "query_id": p.sem_hash, "pipeline": p.pid, "fragment": 0,
            "n_fragments": 1, "op": op,
            "scan_units": p.scan_units[:1],
            "output": {"prefix":
                       f"results/{self._name(p.sem_hash)}/pilot",
                       "partitioning": {"kind": "single"},
                       "schema": p.output_schema},
            "sources": {},
        }
        self.admission.acquire(1, priority=self.priority,
                               group=self.tenant)
        try:
            # attempt=300: outside the fleet's retry (0..2) and
            # straggler-duplicate (100+) attempt ranges, so deterministic
            # fault plans target the probe and the fleet independently
            res = self._invoke(p, spec, report, stats, attempt=300,
                               count_payload=False)
        finally:
            self.admission.release(1)
        if res.error is not None or res.payload is None:
            return
        s = res.payload["stats"]
        if s["rows_in"] <= 0:
            return
        sel = s["rows_out"] / s["rows_in"]
        self.calibration.record(table, pred_key, sel)
        base = self.catalog.table(table).rows
        est0 = p.params.est_out_rows
        p.params.est_out_rows = int(sel * base)
        report.est_rows = p.params.est_out_rows
        # the probe runs serially before the fleet: bill its sim time
        # (report.sim_s is accumulated, not assigned, downstream)
        report.sim_s += (self.platform.dispatch_time_s(1,
                                                       two_level=False)
                         + res.sim_runtime_s)
        a = {"kind": "pilot_scan", "unit_rows": int(s["rows_in"]),
             "selectivity": round(sel, 6),
             "est_rows_from": est0, "est_rows_to": p.params.est_out_rows}
        report.adaptations = list(report.adaptations) + [a]
        self.observer.on_adaptation(self.query_id, p.pid, a)

    # -- semi-join filter pushdown (probe side) -------------------------------
    def _semijoin_filter(self, p: Pipeline, report: PipelineReport,
                         stats: QueryStats) -> dict | None:
        """Resolve an annotated probe pipeline's build-side Bloom filter
        into the fragment-spec payload, or None to launch unfiltered.

        Three gates run in order: a pilot peek at the build's *partial*
        manifest re-decides the plan-time verdict from extrapolated
        observed cardinality (an early revoke skips the wait entirely);
        a bounded wait for the *sealed* filter — a partial filter is
        never applied, missing producers would mean false negatives; and
        a final re-gate on the sealed manifest's exact build figures.
        Every verdict only mutates ``p.params.semijoin`` — the sem hash
        folded the build side at plan time, so filtered and unfiltered
        runs share one cache entry."""
        sj = p.params.semijoin
        if not sj:
            return None
        cfg = self.config
        build_sem = sj["build"]

        def record(a: dict | None) -> None:
            if a:
                report.adaptations = list(report.adaptations) + [a]
                self.observer.on_adaptation(self.query_id, p.pid, a)

        if cfg.pipelined and cfg.adaptive:
            # pilot-K peek: the first landed build producers,
            # extrapolated ×(n/k) — cheap enough to revoke a filter
            # before paying the sealed-filter wait
            for stream in ("l0", "partial"):
                man = self.registry.partial_manifest(self._name(build_sem),
                                                     stream=stream)
                infos = list((man or {}).get("done", {}).values())
                if not infos:
                    continue
                n = max(int(man.get("n_producers") or 0), len(infos), 1)
                scale = n / len(infos)
                rows = sum(i.get("rows", 0) for i in infos) * scale
                sketches = [i["distinct_kmv"] for i in infos
                            if i.get("distinct_kmv")]
                distinct = int(kmv_estimate(kmv_merge(sketches)) * scale) \
                    if sketches else None
                record(self.reoptimizer.semijoin_decision(
                    p, build_rows=rows, build_distinct=distinct))
                break
        if not sj["enabled"]:
            report.semijoin = dict(sj, applied=False)
            return None

        words, build_rows, build_distinct = \
            self._await_build_filter(self._name(build_sem))
        if words is None:
            report.semijoin = dict(sj, applied=False,
                                   reason="filter unavailable")
            return None
        if cfg.adaptive and build_rows is not None:
            record(self.reoptimizer.semijoin_decision(
                p, build_rows=float(build_rows),
                build_distinct=build_distinct))
            if not sj["enabled"]:
                report.semijoin = dict(sj, applied=False)
                return None

        from repro_torch.kernels import bloom as bloomlib
        n_words = len(words) // 4
        wire = {"bits": 32 * n_words, "k": bloomlib.BLOOM_K,
                "mode": sj["mode"], "words": words}
        kept = sj["est_match"] + sj["fpr"] * (1.0 - sj["est_match"])
        report.semijoin = dict(
            sj, applied=True,
            est_killed=int(sj["est_rows"] * max(0.0, 1.0 - kept)))
        if not cfg.pipelined:
            # barrier mode ran the build first in this same stage (see
            # _stage_order), but the stage's sim window is max over its
            # members — waiting for the filter made this probe serial
            # behind the build, so charge the build's window here
            b = next((r for r in stats.pipelines
                      if r.sem_hash == build_sem and not r.cache_hit),
                     None)
            if b is not None:
                report.sim_s += b.sim_s
        return {"key": list(sj["key"]), "bits": wire["bits"],
                "k": wire["k"], "mode": wire["mode"], "words": words}

    def _await_build_filter(self, name: str
                            ) -> tuple[bytes | None, int | None,
                                       int | None]:
        """Merged Bloom words of a *sealed* build exchange, with the
        exact observed build rows/distinct for the final re-gate.

        Resolution order: the complete registry entry's published
        ``semijoin_bloom`` (barrier mode; cached builds), else a sealed
        partial stream every one of whose producer records carries a
        filter shard (pipelined mode — the probe may assemble the
        filter the moment the stream seals, slightly before the entry
        publishes). Returns ``(None, None, None)`` on the bounded-wait
        timeout or an aborted build — the probe then launches
        unfiltered, which is always correct. ``name`` is the build
        pipeline's execution name (``_name``)."""
        deadline = time.time() + self.config.semijoin_wait_timeout_s
        while True:
            entry = self.registry.lookup(name)
            if entry is not None:
                st = entry.get("stats") or {}
                wire = st.get("semijoin_bloom")
                if wire is None:
                    return None, None, None
                pd = st.get("partition_distinct")
                return (wire["words"], st.get("rows_out"),
                        int(sum(pd)) if pd else None)
            for stream in ("l0", "partial"):
                man = self.registry.partial_manifest(name,
                                                     stream=stream)
                if man is None:
                    continue
                if man.get("aborted"):
                    return None, None, None
                if not man.get("complete"):
                    continue
                infos = list((man.get("done") or {}).values())
                if not infos or not all(i.get("bloom") for i in infos):
                    break       # sealed but unfiltered build
                words = None
                for i in infos:
                    w = np.frombuffer(i["bloom"], np.uint32)
                    words = w if words is None else words | w
                sketches = [i["distinct_kmv"] for i in infos
                            if i.get("distinct_kmv")]
                distinct = int(kmv_estimate(kmv_merge(sketches))) \
                    if sketches else None
                rows = int(sum(i.get("rows", 0) for i in infos))
                return words.tobytes(), rows, distinct
            if time.time() >= deadline:
                return None, None, None
            self._check_cancel()
            time.sleep(0.02)

    def _manifest_stats(self, report: PipelineReport) -> dict:
        """The exchange-manifest statistics published with a pipeline's
        registry entry: totals plus the per-partition (rows, bytes,
        distinct-key estimate) observations the adaptive re-optimizer
        feeds on at the next stage barrier."""
        stats = {"rows_out": report.rows_out,
                 "bytes_out": report.bytes_written}
        ps = report.partition_stats
        if ps is not None:
            stats["partition_rows"] = [s["rows"] for s in ps]
            stats["partition_bytes"] = [s["bytes"] for s in ps]
            stats["partition_distinct"] = [kmv_estimate(s["kmv"])
                                           for s in ps]
            # observed per-partition write latencies: the straggler-aware
            # LPT weights (slow storage partitions get dedicated workers)
            stats["partition_write_s"] = [float(s.get("write_s", 0.0))
                                          for s in ps]
            # bytes_out is what a consumer reads — the materialized
            # partitions, not (for multi-level) l0 intermediates too
            stats["bytes_out"] = int(sum(s["bytes"] for s in ps))
        if report.semijoin_bloom is not None:
            # the sealed merged filter: probes of cached builds (and
            # barrier-mode probes) pick it up from the complete entry
            stats["semijoin_bloom"] = report.semijoin_bloom
        return stats

    def _sim_schedule(self, runtimes: list[float]) -> list[float]:
        """Per-fragment simulated completion offsets under per-slot
        admission: list scheduling over ``quota`` slots — each fragment
        starts the moment a slot frees (never on a wave boundary). The
        k-th order statistic of this list is what pipelined downstream
        admission gates on."""
        if not runtimes:
            return []
        slots = [0.0] * min(self.admission.quota, len(runtimes))
        heapq.heapify(slots)
        ends = []
        for r in runtimes:
            t = heapq.heappop(slots) + r
            ends.append(t)
            heapq.heappush(slots, t)
        return ends

    def _sim_makespan(self, runtimes: list[float]) -> float:
        """Simulated completion of a whole fleet (see _sim_schedule).
        With quota ≥ fleet size this is simply ``max(runtimes)``."""
        ends = self._sim_schedule(runtimes)
        return max(ends) if ends else 0.0

    # -- fragment execution with retries/reassignment -----------------------------
    def _run_fragment(self, p: Pipeline, spec: dict,
                      report: PipelineReport, stats: QueryStats,
                      extra_fragments: list[dict]) -> InvocationResult:
        """Run one fragment to success (bounded retries, reassignment).

        Runs inside the platform executor, holding exactly one admission
        slot for its whole lifetime — retries and the reassignment's
        extra worker reuse that slot, so no new admission is requested.
        Thread-safe: many fragments of one pipeline run this
        concurrently.
        """
        attempt = 0
        failed_runtime = 0.0    # failed attempts serialize before success
        extra_runtime = 0.0     # reassigned worker, parallel to the retry
        while True:
            res = self._invoke(p, spec, report, stats, attempt=attempt)
            if res.error is None:
                # the reassigned extra worker races the retry in
                # parallel; the slower of the two is the critical path
                res.sim_runtime_s = failed_runtime + max(
                    res.sim_runtime_s, extra_runtime)
                # per-partition publish: stream this fragment's landed
                # output into the pipeline's partial manifest so gated
                # consumers start/top up before the fleet finishes
                self._publish_partial(p, spec, res)
                return res
            failed_runtime += res.sim_runtime_s
            with self._metrics_lock:
                report.transient_failures += 1
            attempt += 1
            if attempt >= self.config.max_attempts:
                raise QueryAborted(
                    f"pipeline {p.pid} fragment {spec['fragment']} failed "
                    f"{attempt} times",
                    post_mortem={"pipeline": p.pid,
                                 "fragment": spec["fragment"],
                                 "attempts": attempt,
                                 "last_error": res.error})
            # every retry draws from the one per-query budget; a fleet
            # burning through it proves the infrastructure is down, not
            # hiccuping — surface a permanent, typed failure with the
            # last transient cause chained
            if not self.retry_budget.try_spend():
                cause = TransientInfraError(
                    res.error or "transient worker failure")
                raise RetryBudgetExhausted(
                    f"pipeline {p.pid} fragment {spec['fragment']}: "
                    f"per-query retry budget exhausted "
                    f"({self.retry_budget.budget} retries spent)",
                    last_error=cause,
                    spent=self.retry_budget.spent) from cause
            self.observer.on_retry(self.query_id, p.pid, spec["fragment"],
                                   attempt)
            # bounded exponential backoff with full jitter before the
            # re-invoke (decorrelates a fleet retrying one throttled
            # prefix); delays are wall-clock and deliberately tiny
            time.sleep(self.config.retry.backoff_s(attempt))
            # Reassignment: after two failures, split a multi-unit
            # fragment's inputs across an additional fresh worker that
            # runs in parallel with the (now half-sized) retry.
            if attempt >= 2 and len(spec["scan_units"]) > 1:
                with self._metrics_lock:
                    n_extra = len(extra_fragments)
                    spec, extra = self._split_fragment(p, spec, n_extra)
                    extra_fragments.append(extra)
                    report.reassignments += 1
                eres = self._invoke(p, extra, report, stats,
                                    attempt=attempt)
                if eres.error is not None:
                    raise QueryAborted(
                        "reassigned fragment failed",
                        post_mortem={"pipeline": p.pid,
                                     "fragment": extra["fragment"]})
                self._publish_partial(p, extra, eres)
                extra_runtime = max(extra_runtime, eres.sim_runtime_s)

    def _split_fragment(self, p: Pipeline, spec: dict, n_extra: int):
        units = spec["scan_units"]
        half = len(units) // 2
        new_frag = p.n_fragments + n_extra
        second = dict(spec, scan_units=units[half:], fragment=new_frag)
        # narrow the original dict in place: the pipeline's shared specs
        # map must reflect the split, or a later straggler re-trigger of
        # this fragment would re-run the full pre-split input and
        # overwrite its output object with rows the extra fragment also
        # produced (duplicated rows on fetch)
        spec["scan_units"] = units[:half]
        return spec, second

    def _invoke(self, p: Pipeline, spec: dict, report: PipelineReport,
                stats: QueryStats, *, attempt: int,
                count_payload: bool = True) -> InvocationResult:
        res = self.platform.invoke(self.handler, spec, pipeline=p.pid,
                                   fragment=spec["fragment"],
                                   attempt=attempt)
        tier_ops = {}
        with self._metrics_lock:
            report.attempts += 1
            if res.payload is not None:
                s = res.payload["stats"]
                tier_ops = s["tier_ops"]    # real storage ops: billed
                if count_payload:           # …but a duplicate's output
                    report.rows_out += s["rows_out"]    # repeats rows
                    report.bytes_read += s["bytes_read"]
                    report.bytes_written += s["bytes_written"]
                    report.requests += s["requests"]
                    report.exchange_requests += _exchange_requests(
                        spec, tier_ops)
                    report.footer_cache_hits += s.get(
                        "footer_cache_hits", 0)
                    report.semijoin_killed += s.get("semijoin_killed", 0)
                    bw = res.payload.get("bloom")
                    if bw is not None and spec.get("bloom"):
                        self._accumulate_bloom(report, bw, spec["bloom"])
                    if s.get("kernel"):
                        report.kernel_fragments += 1
                    if s.get("pipelined"):
                        # consumer-side pipelined read observations:
                        # first byte = earliest fragment's first batch
                        report.pipelined = True
                        report.topups += s.get("topups", 0)
                        report.overlap_saved_s += s.get(
                            "overlap_saved_s", 0.0)
                        fi = float(s.get("first_input_s", 0.0))
                        if report.first_input_s == 0.0 \
                                or fi < report.first_input_s:
                            report.first_input_s = fi
                    self._merge_partition_stats(
                        report, res.payload.get("partition_stats"))
            cost = self.cost_model.worker_cost(res.sim_runtime_s,
                                               tier_ops)
            report.cost_cents += cost.total_cents
            stats.cost.merge(cost)
        return res

    def _accumulate_bloom(self, report: PipelineReport, words: bytes,
                          bloom_spec: dict) -> None:
        """OR one build fragment's Bloom words into the pipeline's
        merged filter (caller holds the metrics lock). Fragments share
        one spec-time sizing, so a word-count mismatch can only come
        from a foreign stale response — dropped defensively."""
        cur = report.semijoin_bloom
        if cur is None:
            report.semijoin_bloom = {
                "bits": 8 * len(words), "k": bloom_spec["k"],
                "mode": bloom_spec["mode"], "words": words}
        elif len(cur["words"]) == len(words):
            merged = (np.frombuffer(cur["words"], np.uint32)
                      | np.frombuffer(words, np.uint32))
            cur["words"] = merged.tobytes()

    def _merge_partition_stats(self, report: PipelineReport,
                               ps: list | None) -> None:
        """Fold one worker's per-destination stats into the pipeline's
        manifest accumulator (caller holds the metrics lock)."""
        if not ps:
            return
        if report.partition_stats is None:
            report.partition_stats = [
                {"rows": 0, "bytes": 0, "kmv": [], "write_s": 0.0}
                for _ in ps]
        if len(ps) != len(report.partition_stats):  # defensive
            return
        for acc, s in zip(report.partition_stats, ps):
            acc["rows"] += s["rows"]
            acc["bytes"] += s["bytes"]
            acc["kmv"] = kmv_merge([acc["kmv"], s["kmv"]])
            acc["write_s"] += float(s.get("write_s", 0.0))

    # -- plumbing -------------------------------------------------------------
    def _resolve_sources(self, op: dict, *,
                         pipelined: bool = False) -> dict:
        sources: dict[str, dict] = {}

        def collect(o: dict):
            if o["t"] == "scan_exchange":
                sem = o["source"]
                if sem not in sources:
                    if pipelined:
                        sources[sem] = self._await_source(sem)
                    else:
                        entry = self.registry.lookup(self._name(sem))
                        if entry is None:
                            raise QueryAborted(
                                f"upstream result {sem} missing",
                                post_mortem={"source": sem})
                        sources[sem] = entry
            for k in ("child", "probe", "build"):
                if k in o:
                    collect(o[k])
        collect(op)
        return sources

    def _await_source(self, sem: str) -> dict:
        """Pipelined consumer admission: block until the upstream
        pipeline is barrier-complete (returns its registry entry) or
        past the partial-admission gate (returns a pilot-K
        pseudo-entry). An aborted upstream stream is waited out — a
        peer that re-claims the failed execution resets it — until our
        own cancel check (sibling abort) or the wait deadline fires."""
        cfg = self.config
        deadline = time.time() + cfg.pipelined_wait_timeout_s
        floor = self._await_source_gate(sem, deadline)
        name = self._name(sem)
        while True:
            try:
                entry = self.registry.await_source_ready(
                    name, fraction=cfg.pipeline_start_fraction,
                    cost_model=self.cost_model,
                    cancel_check=self._check_cancel,
                    timeout_s=max(deadline - time.time(), 0.01),
                    min_published_at=floor)
            except QueryCancelled:
                raise
            except TimeoutError as e:
                raise QueryAborted(
                    f"upstream result {sem} not ready: {e}",
                    post_mortem={"source": sem}) from e
            except RuntimeError:
                self._check_cancel()
                if time.time() >= deadline:
                    raise QueryAborted(
                        f"upstream producer of {sem} aborted",
                        post_mortem={"source": sem})
                time.sleep(0.05)
                continue
            if entry is not None:
                return entry
            man = self.registry.partial_manifest(name)
            if man is None:
                # sealed and retired between the gate and this read —
                # the barrier-complete entry must exist now
                entry = self.registry.lookup(name)
                if entry is not None and (
                        floor is None
                        or entry.get("published_at", 0.0) >= floor):
                    return entry
                raise QueryAborted(f"upstream result {sem} missing",
                                   post_mortem={"source": sem})
            return self._partial_source_entry(name, man)

    def _await_source_gate(self, sem: str,
                           deadline: float) -> float | None:
        """Block until this plan's producer of ``sem`` has committed to
        a path — a cache hit (any published entry is valid) or a fresh
        execution (only entries published after its stream reset are).
        Consulting the registry earlier races the producer thread: a
        stale complete entry or sealed partial manifest left by an
        earlier query on the same store describes a *different*
        physical layout, and reading through it duplicates or drops
        rows. Returns the freshness floor (``None`` = any entry)."""
        gate = self._source_gates.get(sem)
        if gate is None:
            # not produced by this plan (pre-registered external
            # source): whatever the registry holds is authoritative
            return None
        while not gate["event"].wait(0.05):
            self._check_cancel()
            if time.time() >= deadline:
                raise QueryAborted(
                    f"upstream producer of {sem} never started",
                    post_mortem={"source": sem})
        return gate["floor"]

    def _open_source_gate(self, sem: str,
                          floor: float | None = None) -> None:
        gate = self._source_gates.get(sem)
        if gate is not None:
            gate["floor"] = floor
            gate["event"].set()

    def _partial_source_entry(self, name: str, man: dict) -> dict:
        """Pseudo registry entry for a partially available source: the
        pilot-K estimate — the first K landed producers' stats summed
        and extrapolated ×(n/K) — plus the manifest key consumer
        fragments top up from. Flagged ``partial`` so the re-optimizer
        skips decisions that need the full fleet's observations (e.g.
        empty-partition pruning: a partition empty in the pilot subset
        may still receive rows from later producers)."""
        cfg = self.config
        done = sorted(int(f) for f in (man.get("done") or {}))
        n = max(int(man.get("n_producers") or 0), len(done), 1)
        k = min(len(done), max(cfg.pilot_k, 1))
        est: dict = {}
        if k > 0:
            infos = [man["done"][str(f)] for f in done[:k]]
            scale = n / k
            est = {"rows_out": int(sum(i.get("rows", 0)
                                       for i in infos) * scale),
                   "bytes_out": int(sum(i.get("bytes", 0)
                                        for i in infos) * scale)}
            plists = [i.get("partition_rows") or [] for i in infos]
            D = len(plists[0]) if plists else 0
            if D and all(len(x) == D for x in plists):
                blists = [i.get("partition_bytes") or [] for i in infos]
                wlists = [i.get("partition_write_s") or []
                          for i in infos]
                if all(len(x) == D for x in blists) \
                        and all(len(x) == D for x in wlists):
                    est["partition_rows"] = [
                        int(sum(x[d] for x in plists) * scale)
                        for d in range(D)]
                    est["partition_bytes"] = [
                        int(sum(x[d] for x in blists) * scale)
                        for d in range(D)]
                    # per-byte skew ratios survive the uniform
                    # extrapolation factor, so plain sums suffice here
                    est["partition_write_s"] = [
                        float(sum(x[d] for x in wlists))
                        for d in range(D)]
        return {
            "complete": False, "pipelined": True,
            "partial": {"done": len(done), "of": n, "pilot_k": k},
            "prefix": man.get("prefix") or f"results/{name}",
            "n_fragments": n,
            "partitioning": man.get("partitioning") or {},
            "schema": man.get("schema"),
            "stats": est,
            "manifest_key": self.registry.partial_key(name),
            "wait_timeout_s": cfg.pipelined_wait_timeout_s,
        }

    def _fragment_spec(self, p: Pipeline, f: int, n: int, prefix: str,
                       sources: dict, op: dict | None = None, *,
                       bloom: dict | None = None,
                       semijoin: dict | None = None) -> dict:
        spec = {
            "query_id": p.sem_hash,
            "pipeline": p.pid,
            "fragment": f,
            "n_fragments": n,
            "op": op if op is not None else p.op,
            "scan_units": p.scan_units[f::n],
            "output": {"prefix": prefix,
                       "partitioning": p.partitioning.to_dict(),
                       "schema": p.output_schema},
            "sources": sources,
        }
        if bloom is not None:
            spec["bloom"] = bloom
        if semijoin is not None:
            spec["semijoin"] = semijoin
        if p.params.partition_assignment is not None:
            spec["read_partitions"] = p.params.partition_assignment[f]
        if p.params.source_partitions:
            spec["source_partitions"] = dict(p.params.source_partitions)
        return spec


def _stage_order(plan: PhysicalPlan, stage: list[int]) -> list[int]:
    """Same-stage execution order: pipelines that emit a semi-join
    filter (build sides) run before their same-stage probes, so a
    barrier-mode probe finds the sealed filter instead of waiting out
    its timeout. Same-stage pipelines are mutually independent, so the
    reorder never violates a dependency."""
    return sorted(stage, key=lambda pid: (
        plan.pipelines[pid].params.bloom is None, pid))


def _exchange_requests(spec: dict, tier_ops: dict) -> int:
    """Observed producer-side exchange requests of one worker response:
    PUTs on the exchange tier (and, multilevel, the l0 tier the combined
    intermediates were routed to), plus (merge-wave fragments) the l0
    reads — the figure EXPLAIN ANALYZE compares against the strategy's
    estimate."""
    part = spec["output"]["partitioning"]
    if part.get("kind") != "hash":
        return 0
    tier = part.get("tier", "s3-standard")
    l0_tier = part.get("l0_tier") or spec["op"].get("l0_tier") or tier
    n = (tier_ops.get(tier) or {}).get("put", 0)
    if l0_tier != tier:
        n += (tier_ops.get(l0_tier) or {}).get("put", 0)
    if spec["op"].get("t") == "merge_exchange":
        n += (tier_ops.get(l0_tier) or {}).get("get", 0)
    return n


def _op_kinds(op: dict) -> list[str]:
    kinds = [op["t"]]
    for k in ("child", "probe", "build"):
        if k in op:
            kinds.extend(_op_kinds(op[k]))
    return kinds


def _rows(n: int) -> str:
    return "?" if n < 0 else str(n)


def explain_plan(plan: PhysicalPlan) -> str:
    """Human-readable physical plan: stages, pipelines, fragment fleets."""
    lines = [f"physical plan · {len(plan.pipelines)} pipelines · "
             f"output {plan.output_names}"]
    for si, stage in enumerate(plan.stages()):
        lines.append(f"stage {si}:")
        for pid in stage:
            p = plan.pipelines[pid]
            role = " (root)" if pid == plan.root_pid else ""
            part = p.partitioning
            dest = (f"hash[{','.join(part.keys)}]×{part.n_dest} "
                    f"@{part.tier} ·{part.strategy}"
                    if part.kind == "hash" else "single")
            kern = ""
            if p.kernel:
                rl = p.kernel_roofline or {}
                tile = (f" block={rl['block_rows']}"
                        f" resident={rl['resident_rows']}"
                        f" ({rl['dominant']}-bound)" if rl else "")
                kern = f" · kernel={p.kernel}{tile}"
            lines.append(
                f"  pipeline {pid}{role} · sem={p.sem_hash[:10]} · "
                f"{p.n_fragments} workers · "
                f"in≈{p.input_bytes / 1e6:.1f}MB · "
                f"rows≈{_rows(p.params.est_out_rows)} · "
                f"out={dest}{kern}")
            lines.append("    ops: " + " → ".join(_op_kinds(p.op)[::-1]))
    return "\n".join(lines)


def _describe_adaptation(a: dict) -> str:
    kind = a.get("kind", "?")
    if kind == "fleet_resize":
        return (f"fleet_resize {a['from']}→{a['to']} workers "
                f"(observed {a['observed_bytes'] / 1e6:.2f}MB)")
    if kind == "broadcast_downgrade":
        return (f"broadcast_downgrade build={a['source'][:10]} "
                f"({a['observed_bytes'] / 1e6:.2f}MB ≤ "
                f"{a['budget_bytes'] / 1e6:.2f}MB)")
    if kind == "partition_prune":
        return (f"partition_prune {a['pruned']}/{a['of']} empty "
                f"(source {a['source'][:10]})")
    if kind == "exchange_retier":
        return f"exchange_retier {a['from']}→{a['to']}"
    if kind == "pilot_scan":
        return (f"pilot_scan sel={a['selectivity']:.4f} "
                f"(rows est {a['est_rows_from']}→{a['est_rows_to']})")
    if kind == "exchange_restrategy":
        return (f"exchange_restrategy {a['from']}→{a['to']} "
                f"(est {a['est_requests_from']}→{a['est_requests_to']} "
                f"reqs, {a['cents_from']:.4f}→{a['cents_to']:.4f}¢)")
    if kind in ("semijoin_adopt", "semijoin_revoke"):
        return (f"{kind} build_rows={a['build_rows']} "
                f"match={a['match_fraction']:.4f} "
                f"benefit={a['benefit_cents']:.4f}¢")
    return str(a)


def explain_analyze(plan: PhysicalPlan, stats: QueryStats) -> str:
    """EXPLAIN ANALYZE: the physical plan annotated with observed
    execution — est vs actual rows per pipeline, planned vs invoked
    fleets, and every barrier adaptation applied."""
    reports = {r.pid: r for r in stats.pipelines}
    lines = [f"explain analyze · {len(plan.pipelines)} pipelines · "
             f"sim {stats.sim_latency_s:.3f}s · "
             f"cost {stats.cost.total_cents:.4f}¢"]
    for si, stage in enumerate(plan.stages()):
        lines.append(f"stage {si}:")
        for pid in stage:
            p = plan.pipelines[pid]
            r = reports.get(pid)
            role = " (root)" if pid == plan.root_pid else ""
            if r is None:
                lines.append(f"  pipeline {pid}{role} · not executed")
                continue
            if r.cache_hit:
                tag = "dedup (shared in-flight execution)" if r.deduped \
                    else "cache hit"
                lines.append(
                    f"  pipeline {pid}{role} · {tag} · "
                    f"rows est≈{_rows(r.est_rows)}")
                continue
            workers = (f"{r.n_planned}→{r.n_fragments}"
                       if r.n_fragments != r.n_planned
                       else f"{r.n_fragments}")
            lines.append(
                f"  pipeline {pid}{role} · workers {workers} · "
                f"rows est≈{_rows(r.est_rows)} actual={r.rows_out} · "
                f"{r.requests} reqs · sim {r.sim_s:.3f}s")
            if r.exchange_strategy:
                wave = (f" · merge wave ×{r.merge_fragments}"
                        if r.merge_fragments else "")
                lines.append(
                    f"    exchange: {r.exchange_strategy} · reqs "
                    f"est≈{r.est_exchange_requests} "
                    f"actual={r.exchange_requests}{wave}")
            if r.semijoin is not None:
                sj = r.semijoin
                if sj.get("applied"):
                    lines.append(
                        f"    semijoin: pushed "
                        f"est≈{sj.get('est_killed', 0)} "
                        f"actual={r.semijoin_killed} rows killed · "
                        f"build={sj['build'][:10]} · "
                        f"fpr≈{sj.get('fpr', 0.0):.4f}")
                else:
                    lines.append(
                        f"    semijoin: not pushed "
                        f"({sj.get('reason', 'cost gate')}) · "
                        f"build={sj['build'][:10]}")
            if r.pipelined:
                pilot = f" · pilot-K={r.pilot_k}" if r.pilot_k else ""
                lines.append(
                    f"    pipelined: window "
                    f"{r.sim_start_s:.3f}→{r.sim_end_s:.3f}s · "
                    f"first input {r.first_input_s:.3f}s · "
                    f"{r.topups} top-ups · overlap saved "
                    f"{r.overlap_saved_s:.3f}s{pilot}")
            if r.kernel:
                rl = r.kernel_roofline or {}
                tile = (f" · block={rl['block_rows']} "
                        f"resident={rl['resident_rows']} "
                        f"AI={rl['arithmetic_intensity']} "
                        f"({rl['dominant']}-bound)" if rl else "")
                lines.append(
                    f"    kernel: {r.kernel} × "
                    f"{r.kernel_fragments} fragments{tile}")
            elif r.kernel_miss_reason:
                lines.append(
                    f"    kernel: generic jnp — {r.kernel_miss_reason}")
            lines.append("    ops: " + " → ".join(_op_kinds(p.op)[::-1]))
            for a in r.adaptations:
                lines.append("    adapted: " + _describe_adaptation(a))
    return "\n".join(lines)
