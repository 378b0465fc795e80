"""FaaS platform simulation (paper section 2.1).

Models the pieces of AWS Lambda that shape Skyrise's behavior:

  * cold vs. warm sandbox starts (latencies per paper Table 2) — the warm
    pool grows as sandboxes are created and persists across stages, so cold
    starts are "negligible and only occur in the initial query stage";
  * per-user concurrency quota (admission control) → execution in waves;
  * asynchronous invocation with a small per-request dispatch overhead, and
    the paper's two-level √W invocation tree for large fleets;
  * fault injection (transient errors, stragglers, worker kills) to
    exercise the coordinator's adaptive re-triggering.

Execution is *wall-clock parallel* on this host: the platform owns a
thread-pool ``executor`` bounded by the admission quota, and
``invoke_many`` runs a fleet of fragments concurrently — each fragment
occupies exactly one admission slot, acquired before it is submitted and
released the moment it completes (per-slot release, no wave barrier).
*Simulated* wall-clock is accounted separately as the parallel critical
path over the quota (list-scheduling makespan, see
``QueryEngine._sim_makespan``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np

from repro_torch.core.cost import LAMBDA_COLD_START, LAMBDA_WARM_START
from repro_torch.core.retry import TransientInfraError

# Starvation-avoidance aging: a waiter's effective priority gains one
# level per interval spent waiting, so a steady stream of high-priority
# work can delay low-priority queries but never starve them.
AGING_INTERVAL_S = 5.0


@dataclasses.dataclass
class _Waiter:
    priority: int
    enqueued: float
    seq: int
    group: str | None = None

    def effective(self, now: float, aging_s: float) -> float:
        return self.priority + (now - self.enqueued) / max(aging_s, 1e-9)


class AdmissionController:
    """Cross-query admission control over one function-concurrency quota.

    Every query engine sharing a platform draws its execution waves from
    this ledger, so *concurrently submitted queries* — not just fragments
    within one pipeline — are bounded by the per-user quota (paper
    section 2.1). ``acquire`` blocks until at least one slot is free and
    grants up to ``want`` slots; callers release after the wave returns.

    Freed slots go to the *highest-priority* waiter rather than FIFO:
    waiters carry the owning query's ``priority``, aged upward by
    ``aging_interval_s`` spent waiting (starvation avoidance); ties
    break in arrival order, so equal-priority traffic — the default —
    keeps the original FIFO behavior.

    Multi-tenant weighted fair share (the service tier's per-tenant
    token bucket over this quota): ``set_share(group, weight)`` registers
    a tenant's weight; waiters carrying a weighted ``group`` are ordered
    by *normalized admitted work* — slots ever granted to the group
    divided by its weight — so under sustained contention the granted
    invocation counts converge to the weight ratio. Fair share
    dominates between distinct weighted groups; priority+aging decides
    within a group (and for all group-less waiters, preserving the
    original behavior). A group that stops contending simply stops
    accumulating work — no tenant starves, no tenant banks idle credit
    forever beyond its deficit.

    ``max_in_flight`` is the observed high-water mark (test/ops signal
    that the quota was never exceeded).
    """

    def __init__(self, quota: int, *,
                 aging_interval_s: float = AGING_INTERVAL_S,
                 shares: dict[str, float] | None = None):
        if quota < 1:
            raise ValueError(f"concurrency quota must be >= 1, got {quota}")
        self.quota = quota
        self.aging_interval_s = aging_interval_s
        self._cv = threading.Condition()
        self._in_flight = 0
        self._waiters: list[_Waiter] = []
        self._seq = itertools.count()
        self.max_in_flight = 0
        self.shares: dict[str, float] = dict(shares or {})
        self._admitted: dict[str, int] = {}

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._in_flight

    def set_share(self, group: str, weight: float) -> None:
        """Register (or update) a tenant group's fair-share weight."""
        if weight <= 0:
            raise ValueError(f"share weight must be > 0, got {weight}")
        with self._cv:
            self.shares[group] = float(weight)
            self._cv.notify_all()

    @property
    def admitted_by_group(self) -> dict[str, int]:
        """Slots ever granted per weighted group (fair-share evidence)."""
        with self._cv:
            return dict(self._admitted)

    def _normalized(self, group: str | None) -> float | None:
        """Admitted work normalized by weight; None for unweighted."""
        weight = self.shares.get(group) if group is not None else None
        if not weight:
            return None
        return self._admitted.get(group, 0) / weight

    def _beats(self, a: _Waiter, b: _Waiter, now: float) -> bool:
        """Strict service order: fair-share deficit between distinct
        weighted groups, then effective priority, then arrival."""
        na, nb = self._normalized(a.group), self._normalized(b.group)
        if na is not None and nb is not None and a.group != b.group \
                and na != nb:
            return na < nb
        ae = a.effective(now, self.aging_interval_s)
        be = b.effective(now, self.aging_interval_s)
        if ae != be:
            return ae > be
        return a.seq < b.seq

    def _is_best(self, w: _Waiter, now: float) -> bool:
        return all(o is w or self._beats(w, o, now)
                   for o in self._waiters)

    def acquire(self, want: int, priority: int = 0,
                group: str | None = None) -> int:
        """Block until slots are free *and* this caller is the
        best-ranked waiter (fair share, then priority); grant
        ``min(want, available)``."""
        if want <= 0:
            return 0
        with self._cv:
            w = _Waiter(priority, time.monotonic(), next(self._seq), group)
            self._waiters.append(w)
            try:
                while True:
                    now = time.monotonic()
                    if self.quota - self._in_flight > 0 \
                            and self._is_best(w, now):
                        break
                    # bounded wait: aging can promote a waiter past its
                    # peers even without a release notification
                    self._cv.wait(timeout=self.aging_interval_s / 2)
            finally:
                self._waiters.remove(w)
            grant = min(want, self.quota - self._in_flight)
            self._in_flight += grant
            self.max_in_flight = max(self.max_in_flight, self._in_flight)
            if group is not None and grant > 0:
                self._admitted[group] = self._admitted.get(group, 0) + grant
            # remaining capacity may serve the next-best waiter
            self._cv.notify_all()
            return grant

    def release(self, n: int) -> None:
        if n <= 0:
            return
        with self._cv:
            self._in_flight -= n
            assert self._in_flight >= 0, "admission release underflow"
            self._cv.notify_all()


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection, seeded per (pipeline, fragment,
    attempt)."""
    transient_error_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 10.0      # runtime multiplier when straggling
    kill_fragments: tuple = ()          # (pipeline, fragment, attempt) kills
    straggle_fragments: tuple = ()      # deterministic stragglers
    # Wall-clock sleep added to a straggling invocation (sim time is
    # scaled by straggler_factor regardless). Zero keeps fault tests
    # instant; the pipelined benchmark sets it so barrier-vs-pipelined
    # first-byte gains show up in *real* wall-clock, not just sim time.
    straggle_wall_s: float = 0.0
    seed: int = 0

    def roll(self, pipeline: int, fragment: int, attempt: int):
        rng = np.random.default_rng(
            (self.seed, pipeline, fragment, attempt))
        killed = (pipeline, fragment, attempt) in set(self.kill_fragments)
        transient = rng.random() < self.transient_error_prob
        straggle = (rng.random() < self.straggler_prob
                    or (pipeline, fragment, attempt)
                    in set(self.straggle_fragments))
        return killed or transient, straggle


class TransientWorkerError(TransientInfraError):
    """Infrastructure-level failure (sandbox died, network blip).
    Subclass of the shared :class:`TransientInfraError` taxonomy —
    kept as a name for back-compat with existing callers."""


@dataclasses.dataclass
class InvocationResult:
    payload: dict | None            # worker response (None if failed)
    error: str | None
    sim_start_s: float              # cold/warm start latency
    sim_runtime_s: float            # start + io + compute (straggle-scaled)
    cold: bool
    response: object = None


class FaasPlatform:
    """Simulated function platform shared by all queries in a session."""

    INVOKE_OVERHEAD_S = 0.002       # one async Invoke API call
    MAX_HOST_THREADS = 64           # host-resource cap on the pool size

    def __init__(self, *, quota: int = 1000, seed: int = 0,
                 faults: FaultPlan | None = None, chaos=None):
        self.quota = quota
        self.faults = faults or FaultPlan()
        self.chaos = chaos  # optional ChaosEngine (storms, worker kills)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._warm_sandboxes = 0
        self.invocations = 0
        self.cold_starts = 0
        # Shared ledger: all queries on this platform draw slots from it.
        self.admission = AdmissionController(quota)
        self._executor: ThreadPoolExecutor | None = None

    @property
    def executor(self) -> ThreadPoolExecutor:
        """Wall-clock backend, created on first use: admission bounds
        in-flight fragments to the quota; the pool size additionally
        caps host threads (slots held by queued-but-unstarted tasks
        still release when they run, so a pool smaller than the quota
        cannot deadlock)."""
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=min(self.quota, self.MAX_HOST_THREADS),
                    thread_name_prefix="faas-worker")
            return self._executor

    def close(self) -> None:
        """Shut down the thread pool (a later invocation transparently
        recreates it). Sessions that built their own platform call this
        from ``SkyriseSession.close``."""
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    def __del__(self):
        # backstop for standalone engines/coordinators that default-
        # construct a platform and have no close path: wake the pool's
        # idle threads so an unreferenced platform doesn't strand them
        executor = self.__dict__.get("_executor")
        if executor is not None:
            executor.shutdown(wait=False)

    # -- startup latency draws -------------------------------------------------
    def _start_latency(self, cold: bool) -> float:
        m = LAMBDA_COLD_START if cold else LAMBDA_WARM_START
        lo, hi, avg = m["min"], m["max"], m["avg"]
        # right-skewed: shifted exponential matching the observed mean,
        # clipped to the observed max (paper Table 2)
        return float(min(lo + self._rng.exponential(avg - lo), hi))

    def dispatch_time_s(self, n: int, *, two_level: bool) -> float:
        """Critical-path time to issue n async invocations.

        Flat: the coordinator issues all n serially. Two-level (paper
        section 3.3): it invokes √n workers, each of which invokes √n−1
        more before running its own fragment.
        """
        if n <= 1 or not two_level:
            return n * self.INVOKE_OVERHEAD_S
        root = int(math.ceil(math.sqrt(n)))
        return (root + max(root - 1, 0)) * self.INVOKE_OVERHEAD_S

    # -- invocation --------------------------------------------------------------
    def invoke(self, handler: Callable[[dict], tuple[dict, float]],
               payload: dict, *, pipeline: int, fragment: int,
               attempt: int) -> InvocationResult:
        """Run one worker function. The handler returns
        (response_payload, sim_worker_runtime_s). Thread-safe: sandbox
        bookkeeping is locked; the handler itself runs unlocked so
        concurrent queries overlap."""
        storm = self.chaos is not None and self.chaos.cold_storm()
        with self._lock:
            self.invocations += 1
            # a cold-start storm forces a cold start without draining
            # the warm pool (availability blip, not a pool reset)
            cold = storm or self._warm_sandboxes <= 0
            if cold:
                self.cold_starts += 1
            else:
                self._warm_sandboxes -= 1
            start = self._start_latency(cold)

        fail, straggle = self.faults.roll(pipeline, fragment, attempt)
        if self.chaos is not None and self.chaos.worker_kill():
            fail = True
        if fail:
            # the sandbox died mid-flight; it still cost its startup time
            # but must NOT rejoin the warm pool — the retry pays a fresh
            # (usually cold) start instead of warm-starting on a sandbox
            # the simulation just declared dead
            return InvocationResult(None, "transient", start, start, cold)
        try:
            response, runtime = handler(payload)
        except TransientInfraError as e:
            # worker-side infrastructure failure (sandbox death, storage
            # 503, chaos injection): surfaced as a failed invocation so
            # the coordinator's fragment retry handles it uniformly
            return InvocationResult(None, str(e), start, start, cold)
        if straggle:
            runtime = runtime * self.faults.straggler_factor
            if self.faults.straggle_wall_s > 0:
                time.sleep(self.faults.straggle_wall_s)
        with self._lock:
            self._warm_sandboxes += 1
        return InvocationResult(response, None, start, start + runtime,
                                cold)

    def invoke_many(self, handler: Callable[[dict], tuple[dict, float]],
                    specs: list[dict], *, pipeline: int, attempt: int = 0,
                    cancel_check: Callable[[], None] | None = None,
                    run: Callable[[dict], InvocationResult] | None = None,
                    priority: int = 0, group: str | None = None,
                    on_all_submitted: Callable[[], None] | None = None,
                    ) -> list[InvocationResult]:
        """Run a fleet of fragments concurrently in wall-clock.

        Every fragment occupies exactly one admission slot: the slot is
        acquired (blocking) before the fragment is submitted to the
        executor and released the moment that fragment completes — *not*
        when the whole fleet finishes — so a finished worker's slot is
        immediately available to any query on the platform (per-slot
        release; no wave barrier).

        ``run`` overrides the per-fragment body (the engine passes its
        retry/reassignment wrapper); the default is a single ``invoke``.
        Returns one ``InvocationResult`` per spec, in spec order. If any
        fragment raises, the remaining fragments are drained and the
        first error is re-raised.

        ``on_all_submitted`` fires once the whole fleet sits in the
        executor's FIFO queue. The pipelined engine uses it to flip the
        manifest's ``all_submitted`` flag: consumers admitted after this
        point only wait on work already scheduled ahead of them, which
        keeps partial-input waiting deadlock-free at any quota.
        """
        if run is None:
            def run(spec: dict) -> InvocationResult:
                return self.invoke(handler, spec, pipeline=pipeline,
                                   fragment=spec["fragment"],
                                   attempt=attempt)
        futures: list[Future] = []
        try:
            for spec in specs:
                if cancel_check is not None:
                    cancel_check()
                self.admission.acquire(1, priority=priority, group=group)
                try:
                    fut = self.executor.submit(self._run_slot, run, spec)
                except BaseException:
                    self.admission.release(1)  # slot has no task to free it
                    raise
                futures.append(fut)
        except BaseException:
            # cancelled (or failed) mid-submission: queued-but-unstarted
            # fragments are cancelled outright (their slot never reaches
            # _run_slot, so release it here); already-running ones finish
            # (idempotent writers) and are drained so their slots are
            # back before propagating
            for fut in futures:
                if fut.cancel():
                    self.admission.release(1)
                    continue
                try:
                    fut.result()
                except BaseException:  # noqa: BLE001 - draining
                    pass
            raise
        if on_all_submitted is not None:
            on_all_submitted()
        results: list[InvocationResult] = []
        first_error: BaseException | None = None
        for fut in futures:
            try:
                results.append(fut.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return results

    def _run_slot(self, run: Callable[[dict], InvocationResult],
                  spec: dict) -> InvocationResult:
        try:
            return run(spec)
        finally:
            self.admission.release(1)

