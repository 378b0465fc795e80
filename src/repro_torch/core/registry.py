"""Central (intermediate) result registry (paper section 3.4).

Pipeline results are registered under their *semantic hash* — computed from
the logical plan after logical optimization, before physical properties —
so semantically equivalent results match independent of the number/size of
the workers that produced them. Before scheduling a pipeline, the
coordinator consults the registry and skips cache hits.

Backed by the low-latency KV tier (DynamoDB analog) of the object store.

In-flight dedup (cross-query plan sharing): concurrent queries wanting
the same ``sem_hash`` share one execution instead of racing idempotently.
The protocol is ``claim`` / ``publish`` / ``await_complete``:

  * ``claim(h)`` — conditional-put analog: writes an *incomplete* entry
    and returns True iff no complete or in-flight entry existed; exactly
    one of N concurrent claimants wins and executes the pipeline;
  * losers call ``await_complete(h)`` and block until the owner
    ``publish``-es the finished entry (they then treat it as a cache
    hit) or ``abandon``-s the claim (owner failed/cancelled — a waiter
    re-claims and executes itself);
  * claims live in the same KV tier as results, so dedup spans *all*
    sessions sharing one store, not just queries inside one session.

Incremental (pipelined) manifests: alongside the all-or-nothing entry at
``{ns}/{h}``, a producing pipeline streams per-fragment completion into a
*partial manifest* at ``{ns}/{h}.partial`` (and ``{ns}/{h}.l0`` for a
multilevel exchange's level-0 objects). Each ``publish_partial`` is a
versioned read-modify-write whose put doubles as the notification — the
same ``ObjectStore.watch`` wake-up that backs claim waiting — so
consumers block on *manifest versions*, not polling loops. A consumer is
released by ``await_source_ready`` once (a) the producer fleet is fully
submitted to the platform (``all_submitted`` — the deadlock-freedom gate:
waiters then only ever wait on already-running workers) and (b) a
configurable fraction of producer partitions has landed. Streams are
*sealed* (flagged complete) by ``finish_partial`` when the producer fleet
is done — deleting them would race consumers mid-top-up; they are only
deleted with the main entry by ``invalidate``. A dying producer flags its
streams ``aborted`` so in-flight consumer workers fail fast instead of
timing out.
"""

from __future__ import annotations

import math
import threading
import time
import uuid

from repro_torch.storage import msgpack_codec as msgpack

from repro_torch.storage.object_store import ObjectStore

# One process-wide lock serializes claim writes across every registry
# instance sharing this interpreter (the conditional-put analog needs a
# read-check-write critical section). Waiter wake-ups go through the
# store's ``watch`` primitive instead: publish/abandon are ordinary
# puts/deletes, which the KV backend turns into notifications (memory)
# or version-poll wake-ups with exponential backoff (filesystem) — no
# billed KV reads happen while waiting.
_CLAIM_LOCK = threading.Lock()

# Suffixes of the incremental-manifest side keys riding next to a result
# entry. "partial" is the pipeline's main output stream; "l0" is the
# multilevel exchange's level-0 stream (merge wave input).
PARTIAL_STREAMS = ("partial", "l0")


def read_manifest(store: ObjectStore, key: str) -> dict | None:
    """Worker-side manifest read: ``store`` must already be on the KV
    tier and ``key`` fully namespace-resolved (the fragment spec carries
    it verbatim). Fragments use this with ``store.watch`` for their
    top-up loop without constructing a registry."""
    if not store.exists(key):
        return None
    return msgpack.unpackb(store.get(key).data)


def partitions_ready(manifest: dict, fraction: float | None,
                     *, cost_model=None) -> bool:
    """The consumer-admission gate: a configurable fraction of producer
    partitions landed AND every producer invocation has been submitted
    to the platform's FIFO executor. The second condition is what keeps
    pipelined waiting deadlock-free — an admitted consumer only ever
    waits on producers that are already running or queued ahead of it.

    ``fraction=None`` delegates the choice to the cost model: the
    landed partitions' producer wall times (``wall_s`` in the manifest
    infos) are a pilot sample of the fleet's runtime skew, and
    ``cost_model.pipeline_admission_fraction`` picks the fraction that
    minimizes the expected consumer finish under them. No observations
    (or no cost model) fall back to the 0.5 constant."""
    if manifest.get("complete"):
        return True
    if not manifest.get("all_submitted"):
        return False
    done = manifest.get("done") or {}
    if fraction is None:
        walls = [i["wall_s"] for i in done.values()
                 if isinstance(i, dict) and i.get("wall_s") is not None]
        fraction = (cost_model.pipeline_admission_fraction(walls)
                    if cost_model is not None and walls else 0.5)
    n = max(1, int(manifest.get("n_producers") or 1))
    need = max(1, math.ceil(fraction * n))
    return len(done) >= need


class ResultRegistry:
    def __init__(self, store: ObjectStore, namespace: str = "registry",
                 claim_ttl_s: float = 60.0, *,
                 result_ttl_s: float | None = None,
                 max_entries: int | None = None):
        self.store = store.with_tier("dynamodb")
        self.namespace = namespace
        # A claim whose owner died without abandoning (process killed)
        # must not hang waiters forever: past the TTL it counts as
        # abandoned and the next claimant steals it. Stealing a claim
        # whose owner is merely slow is safe — workers are idempotent
        # single-object writers, so a racing duplicate execution only
        # wastes invocations, never corrupts results.
        self.claim_ttl_s = claim_ttl_s
        # Bounded-cache policy (the registry otherwise grows without
        # bound): entries older than ``result_ttl_s`` expire lazily at
        # lookup; past ``max_entries`` complete entries, the lowest
        # keep-score — recompute cost divided by age, so old *and*
        # cheap-to-recompute results go first — is evicted.
        self.result_ttl_s = result_ttl_s
        self.max_entries = max_entries
        self.claims = 0         # executions this registry won via claim()
        self.dedup_hits = 0     # await_complete() calls resolved by a peer
        self.evictions = 0      # TTL expirations + capacity evictions
        self._owned: dict[str, str] = {}    # sem_hash → our claim token

    def _key(self, sem_hash: str) -> str:
        return f"{self.namespace}/{sem_hash}"

    def partial_key(self, sem_hash: str, stream: str = "partial") -> str:
        return f"{self.namespace}/{sem_hash}.{stream}"

    def _read(self, sem_hash: str) -> dict | None:
        key = self._key(sem_hash)
        if not self.store.exists(key):
            return None
        return msgpack.unpackb(self.store.get(key).data)

    def lookup(self, sem_hash: str) -> dict | None:
        """Returns the result's physical layout metadata, or None (absent
        entries and in-flight claims both miss). Entries older than
        ``result_ttl_s`` expire lazily here — the expired entry is
        deleted and the lookup misses, so the caller recomputes."""
        entry = self._read(sem_hash)
        if not (entry and entry.get("complete")):
            return None
        if self._expired(entry):
            self.invalidate(sem_hash)
            self.evictions += 1
            return None
        return entry

    def _expired(self, entry: dict) -> bool:
        return (self.result_ttl_s is not None
                and time.time() - entry.get("published_at", time.time())
                > self.result_ttl_s)

    # -- in-flight dedup -----------------------------------------------------
    def _stale(self, entry: dict) -> bool:
        return (not entry.get("complete")
                and time.time() - entry.get("claimed_at", 0.0)
                > self.claim_ttl_s)

    def _chaos(self):
        return getattr(self.store, "chaos", None)

    def _kill_once(self, site: str) -> None:
        chaos = self._chaos()
        if chaos is not None:
            chaos.kill_once(site)

    def claim(self, sem_hash: str) -> bool:
        """Atomically claim execution of ``sem_hash``.

        True → the caller owns the (single) execution and must finish
        with ``publish`` or ``abandon``. False → the result is already
        complete or another query is executing it (``await_complete``).
        A claim older than ``claim_ttl_s`` is stolen (orphaned owner).

        The claim write is a *versioned CAS*: the claimant captures the
        key's version token before deciding and the put lands only if
        the key is still at that version. Two waiters observing the same
        TTL-expired claim both decide to steal — exactly one conditional
        put wins; the loser sees the version move and backs off to
        ``await_complete``. (The in-process lock only serializes local
        claimants; cross-process exclusion comes from the CAS.)
        """
        key = self._key(sem_hash)
        with _CLAIM_LOCK:
            token0 = self.store.version(key)
            entry = self._read(sem_hash)
            if entry is not None and not self._stale(entry):
                return False
            token = uuid.uuid4().hex
            blob = msgpack.packb({"complete": False,
                                  "claimed_at": time.time(),
                                  "owner": token})
            if not self.store.put_if_version(key, blob, token0):
                return False    # lost the steal race to another claimant
            # chaos: owner dies right after writing its claim and before
            # recording ownership — the claim is orphaned (no abandon
            # path) and must be TTL-stolen by a waiter
            self._kill_once("registry.claim")
            self._owned[sem_hash] = token
            self.claims += 1
            return True

    def publish(self, sem_hash: str, *, prefix: str, n_fragments: int,
                partitioning: dict, schema: list[dict],
                stats: dict | None = None,
                cost_cents: float = 0.0) -> None:
        """Register the finished result and wake every waiter."""
        self.register(sem_hash, prefix=prefix, n_fragments=n_fragments,
                      partitioning=partitioning, schema=schema,
                      stats=stats, cost_cents=cost_cents)
        # the put itself is the notification: store watchers wake
        self._owned.pop(sem_hash, None)

    def abandon(self, sem_hash: str) -> None:
        """Drop an unfinished claim (owner failed or was cancelled) so a
        waiter can re-claim and run the pipeline itself. Only the claim
        this registry wrote is deleted — if the claim was TTL-stolen in
        the meantime, the stealer's live claim stays untouched."""
        with _CLAIM_LOCK:
            token = self._owned.pop(sem_hash, None)
            entry = self._read(sem_hash)
            if (entry is not None and not entry.get("complete")
                    and entry.get("owner") == token):
                # the delete is the notification: store watchers wake
                self.store.delete(self._key(sem_hash))

    def await_complete(self, sem_hash: str,
                       cancel_check=None) -> dict | None:
        """Block until the in-flight execution of ``sem_hash`` resolves.

        Returns the complete entry if the owner published it (treat as a
        cache hit), or None if the claim was abandoned — explicitly, or
        implicitly by exceeding ``claim_ttl_s`` (orphaned owner) —
        after which the caller should try to ``claim`` again.
        ``cancel_check`` is polled while waiting and may raise to abort
        the wait.

        Waiting is *event-driven*: the claim key's version token is
        captured before each read, then ``store.watch`` blocks until a
        writer changes the key (publish overwrites it, abandon deletes
        it) or the claim's TTL runs out. Version observation is a HEAD
        analog, so no billed KV requests are issued while waiting — the
        billed re-read happens once per actual change.
        """
        key = self._key(sem_hash)
        while True:
            # token BEFORE read: a publish that lands between the two is
            # caught by watch() returning immediately on the stale token
            token = self.store.version(key)
            entry = self._read(sem_hash)
            if entry is None or self._stale(entry):
                return None
            if entry.get("complete"):
                self.dedup_hits += 1
                return entry
            if cancel_check is not None:
                cancel_check()
            # wake on publish/abandon, or when the TTL can have expired
            # (orphaned owner) — whichever comes first
            ttl_left = self.claim_ttl_s - (time.time()
                                           - entry.get("claimed_at", 0.0))
            self.store.watch(key, token, timeout_s=max(ttl_left, 0.0) + 0.01,
                             cancel_check=cancel_check)

    # -- incremental (pipelined) manifests -----------------------------------
    def begin_partial(self, sem_hash: str, *, stream: str = "partial",
                      n_producers: int, prefix: str,
                      partitioning: dict | None = None,
                      schema: list[dict] | None = None) -> str:
        """Open a partial manifest before any producer runs, so consumers
        admitted mid-fleet already see the layout metadata. Returns the
        manifest key (fragment specs carry it verbatim).

        The manifest is written *fresh*: any leftover state belongs to a
        dead prior owner (an ``aborted`` flag from an execution whose
        claim this caller just re-won must not poison the new run, and
        stale ``done`` entries will be republished idempotently)."""
        key = self.partial_key(sem_hash, stream)
        with _CLAIM_LOCK:
            old = read_manifest(self.store, key)
            man = {"done": {}, "all_submitted": False, "aborted": False,
                   "version": (old or {}).get("version", 0) + 1,
                   "n_producers": n_producers, "prefix": prefix,
                   "partitioning": partitioning, "schema": schema}
            self.store.put(key, msgpack.packb(man))
            # chaos: owner dies right after opening the stream — the
            # fresh manifest (no done entries) is orphaned; the re-won
            # claim rewrites it fresh
            self._kill_once("registry.begin_partial")
        return key

    def publish_partial(self, sem_hash: str, fragment: int, info: dict, *,
                        stream: str = "partial",
                        n_producers: int | None = None) -> None:
        """Record one producer fragment's completed output (its stats +
        written layout) in the stream's partial manifest. The put wakes
        every watcher — this is the per-partition publish event that
        replaces the stage barrier. ``n_producers`` may grow past the
        planned fleet when a failing fragment is reassigned (split)."""
        key = self.partial_key(sem_hash, stream)
        with _CLAIM_LOCK:
            man = read_manifest(self.store, key) or {
                "done": {}, "all_submitted": False, "aborted": False,
                "version": 0}
            man["done"][str(fragment)] = info
            if n_producers is not None:
                man["n_producers"] = max(n_producers,
                                         man.get("n_producers") or 0)
            man["version"] += 1
            self.store.put(key, msgpack.packb(man))
        # chaos: owner dies right after landing one partition — consumers
        # may already be topping up from it; the abort/abandon path must
        # poison the stream and let a waiter re-run the pipeline
        self._kill_once("registry.publish_partial")
        if "bloom" in info:
            # chaos: owner dies right after landing a semi-join filter
            # shard — a probe waiting on the sealed filter must see the
            # abort (or its wait timeout) and fall back to unfiltered
            self._kill_once("registry.publish_filter")

    def mark_all_submitted(self, sem_hash: str, n_producers: int, *,
                           stream: str = "partial") -> None:
        """Flag that every producer invocation sits in the platform's
        FIFO executor queue. Consumers are only admitted after this —
        they then wait exclusively on work scheduled ahead of them, so
        the wait-for graph stays acyclic at any quota."""
        key = self.partial_key(sem_hash, stream)
        with _CLAIM_LOCK:
            man = read_manifest(self.store, key)
            if man is None:
                return
            man["all_submitted"] = True
            man["n_producers"] = max(n_producers,
                                     man.get("n_producers") or 0)
            man["version"] += 1
            self.store.put(key, msgpack.packb(man))

    def abort_partial(self, sem_hash: str) -> None:
        """Poison every stream of a failed producer pipeline: waiters
        (engine gates and in-flight consumer workers) see ``aborted``
        and raise instead of blocking until their wait timeout."""
        for stream in PARTIAL_STREAMS:
            key = self.partial_key(sem_hash, stream)
            with _CLAIM_LOCK:
                man = read_manifest(self.store, key)
                if man is None or man.get("aborted"):
                    continue
                man["aborted"] = True
                man["version"] += 1
                self.store.put(key, msgpack.packb(man))

    def finish_partial(self, sem_hash: str, *,
                       n_producers: int | None = None,
                       stream: str = "partial") -> None:
        """Seal a stream: every producer (including reassignment splits)
        has published, so ``n_producers`` is final and in-flight top-up
        loops may drain and stop watching. The manifest stays until
        ``invalidate`` deletes it with the main entry — removing it here
        would race consumers still reading their last top-up batch."""
        # chaos: owner dies with every producer done but the stream not
        # yet sealed — the next owner re-runs and seals
        self._kill_once("registry.finish_partial")
        key = self.partial_key(sem_hash, stream)
        with _CLAIM_LOCK:
            man = read_manifest(self.store, key)
            if man is None:
                return
            man["complete"] = True
            man["all_submitted"] = True
            if n_producers is not None:
                man["n_producers"] = n_producers
            man["version"] += 1
            self.store.put(key, msgpack.packb(man))

    def partial_manifest(self, sem_hash: str,
                         stream: str = "partial") -> dict | None:
        return read_manifest(self.store,
                             self.partial_key(sem_hash, stream))

    def await_source_ready(self, sem_hash: str, *,
                           fraction: float | None,
                           cost_model=None,
                           stream: str = "partial", cancel_check=None,
                           timeout_s: float | None = None,
                           min_published_at: float | None = None
                           ) -> dict | None:
        """Block until ``sem_hash`` is readable as a consumer input:
        either barrier-complete (returns the complete entry) or
        partially available past the admission gate (returns ``None`` —
        the caller reads the partial manifest and tops up). Raises
        RuntimeError if the producer aborted, TimeoutError past
        ``timeout_s``.

        ``min_published_at`` is the consumer's freshness floor: a
        complete entry published before it is *stale* — left by an
        earlier query whose producer fleet (and therefore object
        layout) may differ from the one re-executing right now — and
        is ignored in favor of the live partial stream."""
        key = self.partial_key(sem_hash, stream)
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            token = self.store.version(key)
            entry = self._read(sem_hash)
            if entry is not None and entry.get("complete") \
                    and (min_published_at is None
                         or entry.get("published_at", 0.0)
                         >= min_published_at):
                return entry
            man = read_manifest(self.store, key)
            if man is not None:
                if man.get("aborted"):
                    raise RuntimeError(
                        f"producer pipeline {sem_hash[:12]} aborted")
                if partitions_ready(man, fraction, cost_model=cost_model):
                    return None
            if cancel_check is not None:
                cancel_check()
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError(
                    f"source {sem_hash[:12]} not ready after {timeout_s}s")
            # Bounded watch: a peer session may barrier-publish the main
            # entry without ever touching this stream's partial key, so
            # re-check the complete entry at least every quarter second.
            self.store.watch(key, token, timeout_s=0.25,
                             cancel_check=cancel_check)

    # -- completed entries ---------------------------------------------------
    def register(self, sem_hash: str, *, prefix: str, n_fragments: int,
                 partitioning: dict, schema: list[dict],
                 stats: dict | None = None,
                 cost_cents: float = 0.0) -> None:
        self.store.put(self._key(sem_hash), msgpack.packb({
            "complete": True,
            "prefix": prefix,
            "n_fragments": n_fragments,
            "partitioning": partitioning,
            "schema": schema,
            "stats": stats or {},
            "published_at": time.time(),
            "cost_cents": cost_cents,
        }))
        if self.max_entries is not None:
            self._evict_over_capacity()

    def _evict_over_capacity(self) -> None:
        """Evict complete entries past ``max_entries``, lowest keep-score
        first. Keep-score = recompute cost / age: a result that was
        expensive to produce or was published recently is worth cache
        space; an old, cheap one is not (age × recompute-cost policy)."""
        names = [k for k in self.store.list(f"{self.namespace}/")
                 if "." not in k.rsplit("/", 1)[-1]]
        scored: list[tuple[float, str]] = []
        for key in names:
            sem = key.rsplit("/", 1)[-1]
            entry = self._read(sem)
            if not (entry and entry.get("complete")):
                continue    # in-flight claims are not cache entries
            age = max(time.time() - entry.get("published_at", 0.0), 1e-6)
            scored.append((entry.get("cost_cents", 0.0) / age, sem))
        excess = len(scored) - self.max_entries
        if excess <= 0:
            return
        scored.sort()
        for _, sem in scored[:excess]:
            self.invalidate(sem)
            self.evictions += 1

    def invalidate(self, sem_hash: str) -> None:
        self.store.delete(self._key(sem_hash))
        for stream in PARTIAL_STREAMS:
            self.store.delete(self.partial_key(sem_hash, stream))
