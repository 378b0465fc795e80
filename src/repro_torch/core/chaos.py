"""Seeded, deterministic full-stack fault injection (the chaos engine).

The paper's core claim is that a fully serverless query processor stays
*robust* on unreliable, fine-grained infrastructure. ``FaultPlan``
(core.platform) already exercises the worker path — transient invoke
failures and stragglers — but the layers whose correctness the runtime
actually depends on (storage writes, the registry's claim/partial-
manifest protocol, the service ledger's state machine) were never run
under adversarial schedules. This module injects faults at *every*
layer through one shared, seeded schedule:

  ===================  =====================================================
  site                 fault
  ===================  =====================================================
  ``storage.get``      transient GET error / 503 throttle / latency spike
  ``storage.put``      transient PUT error / sandbox death mid-PUT leaving a
                       *torn partial object* (prefix of the bytes)
  ``platform.cold``    cold-start storm (warm sandboxes unavailable)
  ``platform.kill``    worker killed mid-fragment (beyond ``FaultPlan``)
  ``registry.claim``   owner dies right after writing its claim (orphan)
  ``registry.begin_partial``    owner dies after opening the stream
  ``registry.publish_partial``  owner dies after landing one partition
  ``registry.finish_partial``   owner dies before sealing the stream
  ``ledger.<STATUS>``  service instance dies right after the CAS landing
                       the ``<STATUS>`` transition (ADMITTED, RUNNING, …)
  ===================  =====================================================

Two injection shapes:

  * **probabilistic** rolls (storage faults, cold storms, worker kills) —
    each decision is an independent draw from an rng seeded by
    ``(seed, site, call-counter)``, so a given seed produces the same
    fault schedule on every run: a red CI run is reproduced locally from
    its seed alone;
  * **one-shot kill points** (``kill_points``) — named protocol steps
    that raise :class:`ChaosKill` exactly once per site, modeling the
    owner process dying at that exact step. The recovery machinery
    (claim TTL steal, partial-stream reset, ledger lease expiry) must
    then finish the work — with byte-identical results and no duplicate
    fleet work.

``ChaosKill`` subclasses :class:`TransientInfraError`: to the rest of
the stack a chaos death is indistinguishable from a real one, so the
handling exercised is exactly the production path. The KV tier
(``dynamodb``) is exempt from *storage* faults — conditional writes
there are atomic in the modeled backend — its failure modes are the
explicit protocol kill points instead.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib

import numpy as np

from repro_torch.core.retry import TransientInfraError


class ChaosKill(TransientInfraError):
    """The process was killed at a named protocol step."""

    def __init__(self, site: str):
        super().__init__(f"chaos: killed at {site}")
        self.site = site


@dataclasses.dataclass
class ChaosConfig:
    """Knobs of one chaos schedule. All probabilities default to zero so
    an empty config injects nothing; ``seed`` makes any non-zero
    schedule reproducible."""

    seed: int = 0
    # -- storage (S3 analog) faults -----------------------------------------
    get_error_prob: float = 0.0       # transient GET failure
    put_error_prob: float = 0.0       # transient PUT failure (no bytes land)
    throttle_prob: float = 0.0        # 503 SlowDown: fails AND bills latency
    throttle_latency_s: float = 0.05  # per-503 latency charged to the caller
    latency_spike_prob: float = 0.0   # the heavy first-byte tail
    latency_spike_factor: float = 20.0
    torn_put_prob: float = 0.0        # sandbox death mid-PUT: prefix lands
    # -- platform faults ----------------------------------------------------
    cold_storm_prob: float = 0.0      # invocation cold-starts despite pool
    worker_kill_prob: float = 0.0     # sandbox killed mid-fragment
    # -- one-shot protocol kill points --------------------------------------
    # site names from the table above; each fires exactly once
    kill_points: tuple = ()


class ChaosEngine:
    """Deterministic fault scheduler shared by every layer of one
    session/service. Thread-safe; disable with ``pause()`` (e.g. while
    fetching results for a parity check — the verification read path is
    not the system under test)."""

    def __init__(self, config: ChaosConfig | None = None):
        self.config = config or ChaosConfig()
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._fired_kills: set[str] = set()
        self.enabled = True
        # observability: injected-fault counts per site/kind, asserted on
        # by the chaos harness ("this run actually injected faults")
        self.injected: dict[str, int] = {}

    # -- bookkeeping ---------------------------------------------------------
    def _rng(self, site: str) -> np.random.Generator:
        """Per-(seed, site, call-counter) rng: the n-th decision at a
        site is the same for a given seed on every run."""
        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
        return np.random.default_rng(
            (self.config.seed, zlib.crc32(site.encode()), n))

    def _record(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    def pause(self) -> "_Paused":
        """Context manager suspending all injection (parity fetches,
        reference reads)."""
        return _Paused(self)

    # -- one-shot protocol kill points ---------------------------------------
    def kill_once(self, site: str) -> None:
        """Raise :class:`ChaosKill` the first time ``site`` is reached
        (when listed in ``kill_points``); later calls pass."""
        if not self.enabled or site not in self.config.kill_points:
            return
        with self._lock:
            if site in self._fired_kills:
                return
            self._fired_kills.add(site)
            self.injected[f"kill:{site}"] = 1
        raise ChaosKill(site)

    # -- storage faults ------------------------------------------------------
    def storage_fault(self, op: str, key: str) -> str | None:
        """Roll the fault (if any) for one storage request. Returns
        ``None`` | ``"transient"`` | ``"throttle"`` | ``"torn"`` (PUTs
        only); latency spikes are reported via :meth:`latency_scale`
        separately so they compose with error-free requests."""
        c = self.config
        if not self.enabled:
            return None
        rng = self._rng(f"storage.{op}")
        err = c.get_error_prob if op == "get" else c.put_error_prob
        if rng.random() < err:
            self._record(f"storage.{op}.transient")
            return "transient"
        if rng.random() < c.throttle_prob:
            self._record(f"storage.{op}.throttle")
            return "throttle"
        if op == "put" and rng.random() < c.torn_put_prob:
            self._record("storage.put.torn")
            return "torn"
        return None

    def latency_scale(self, op: str) -> float:
        """Multiplier on one request's simulated latency draw (the
        first-byte tail the hedged-read path races against)."""
        c = self.config
        if not self.enabled or c.latency_spike_prob <= 0.0:
            return 1.0
        rng = self._rng(f"storage.{op}.latency")
        if rng.random() < c.latency_spike_prob:
            self._record(f"storage.{op}.spike")
            return c.latency_spike_factor
        return 1.0

    # -- platform faults -----------------------------------------------------
    def cold_storm(self) -> bool:
        """True → this invocation cold-starts even with warm sandboxes
        available (the pool itself is untouched — a storm is an
        availability blip, not a pool reset)."""
        c = self.config
        if not self.enabled or c.cold_storm_prob <= 0.0:
            return False
        if self._rng("platform.cold").random() < c.cold_storm_prob:
            self._record("platform.cold_storm")
            return True
        return False

    def worker_kill(self) -> bool:
        """True → the sandbox dies mid-fragment (generalizes
        ``FaultPlan.kill_fragments`` into the shared schedule)."""
        c = self.config
        if not self.enabled or c.worker_kill_prob <= 0.0:
            return False
        if self._rng("platform.kill").random() < c.worker_kill_prob:
            self._record("platform.worker_kill")
            return True
        return False


class _Paused:
    def __init__(self, chaos: ChaosEngine):
        self._chaos = chaos

    def __enter__(self) -> ChaosEngine:
        self._chaos.enabled = False
        return self._chaos

    def __exit__(self, *exc) -> None:
        self._chaos.enabled = True
