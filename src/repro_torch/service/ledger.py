"""Durable request ledger on the KV tier (service subsystem).

Every query submitted to the service gets a persistent record in the
shared low-latency KV tier (DynamoDB analog) — *not* in any service
process — tracking it through an explicit lifecycle::

    QUEUED → ADMITTED → RUNNING → SUCCEEDED | FAILED | CANCELLED
                 ↑__________________________________|
                 (lease expiry re-queues orphans)

Coordination state living in serverless storage is what lets the service
itself be serverless: a restarted (or second) service process reads the
ledger and picks up exactly where the dead one stopped. The concurrency
protocol is the same ownership-token pattern as the result registry's
claims:

  * every write is a *versioned put* — a compare-and-swap analog: the
    writer re-reads the entry, checks the version (and, for owned
    entries, its ownership token) inside a critical section, and writes
    version+1; a stale writer loses and raises ``LedgerConflict``;
  * ADMITTED/RUNNING entries carry the owning service's token and a
    TTL lease; ``recover_expired`` re-queues entries whose lease ran
    out (owner died mid-flight), bumping ``attempt`` — workers are
    idempotent single-object writers, so a re-run after a *published*
    result is absorbed by the semantic result cache instead of
    re-executing the fleet.

Like the registry, in-process mutual exclusion (one module lock) stands
in for the KV store's conditional-put primitive; cross-process safety
comes from the versioned read-check-write being the only write path.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
import uuid

from repro_torch.storage import msgpack_codec as msgpack

from repro_torch.storage.object_store import ObjectStore

_LEDGER_LOCK = threading.Lock()


class RequestStatus(str, enum.Enum):
    QUEUED = "QUEUED"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.SUCCEEDED, RequestStatus.FAILED,
                        RequestStatus.CANCELLED)


# Legal status transitions; ADMITTED/RUNNING → QUEUED is the lease-expiry
# re-queue path (orphaned owner), nothing leaves a terminal state.
_ALLOWED: dict[RequestStatus, set[RequestStatus]] = {
    RequestStatus.QUEUED: {RequestStatus.ADMITTED, RequestStatus.CANCELLED,
                           RequestStatus.FAILED},
    RequestStatus.ADMITTED: {RequestStatus.RUNNING, RequestStatus.QUEUED,
                             RequestStatus.CANCELLED, RequestStatus.FAILED},
    RequestStatus.RUNNING: {RequestStatus.SUCCEEDED, RequestStatus.FAILED,
                            RequestStatus.CANCELLED, RequestStatus.QUEUED},
    RequestStatus.SUCCEEDED: set(),
    RequestStatus.FAILED: set(),
    RequestStatus.CANCELLED: set(),
}


class LedgerConflict(RuntimeError):
    """A versioned put lost its compare-and-swap (stale version, foreign
    owner, or illegal transition)."""


@dataclasses.dataclass
class LedgerEntry:
    """One persistent query record (the KV tier's unit of truth)."""

    request_id: str
    sql: str
    tenant: str | None = None
    priority: int = 0
    deadline_s: float | None = None
    status: RequestStatus = RequestStatus.QUEUED
    version: int = 1
    owner: str | None = None        # service token while ADMITTED/RUNNING
    lease_expires: float = 0.0      # wall-clock lease deadline
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    attempt: int = 0                # lease-expiry re-queues bump this
    result: dict | None = None      # result pointer once SUCCEEDED
    error: str | None = None
    dag_id: str | None = None
    depends_on: list[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["status"] = self.status.value
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LedgerEntry":
        d = dict(d)
        d["status"] = RequestStatus(d["status"])
        d["depends_on"] = list(d.get("depends_on") or [])
        return cls(**d)


class RequestLedger:
    """Versioned-put request records on the shared KV tier."""

    def __init__(self, store: ObjectStore, namespace: str = "ledger",
                 lease_ttl_s: float = 30.0):
        self.store = store.with_tier("dynamodb")
        self.namespace = namespace
        self.lease_ttl_s = lease_ttl_s

    def _key(self, request_id: str) -> str:
        return f"{self.namespace}/{request_id}"

    def _read(self, request_id: str) -> LedgerEntry | None:
        key = self._key(request_id)
        if not self.store.exists(key):
            return None
        return LedgerEntry.from_dict(
            msgpack.unpackb(self.store.get(key).data))

    def _write(self, entry: LedgerEntry) -> None:
        self.store.put(self._key(entry.request_id),
                       msgpack.packb(entry.to_dict()))

    # -- submission ----------------------------------------------------------
    def submit(self, sql: str, *, tenant: str | None = None,
               priority: int = 0, deadline_s: float | None = None,
               request_id: str | None = None,
               dag_id: str | None = None,
               depends_on: list[str] | None = None) -> LedgerEntry:
        """Persist a new QUEUED record; the id is the durable handle."""
        entry = LedgerEntry(
            request_id=request_id or uuid.uuid4().hex,
            sql=sql, tenant=tenant, priority=priority,
            deadline_s=deadline_s, submitted_at=time.time(),
            dag_id=dag_id, depends_on=list(depends_on or []))
        with _LEDGER_LOCK:
            if self.store.exists(self._key(entry.request_id)):
                raise LedgerConflict(
                    f"request {entry.request_id} already exists")
            self._write(entry)
        return entry

    # -- reads ---------------------------------------------------------------
    def get(self, request_id: str) -> LedgerEntry | None:
        return self._read(request_id)

    def entries(self, *, tenant: str | None = None,
                status: RequestStatus | None = None) -> list[LedgerEntry]:
        """All records (optionally filtered), oldest submission first."""
        out = []
        for key in self.store.list(f"{self.namespace}/"):
            entry = self._read(key[len(self.namespace) + 1:])
            if entry is None:
                continue
            if tenant is not None and entry.tenant != tenant:
                continue
            if status is not None and entry.status is not status:
                continue
            out.append(entry)
        out.sort(key=lambda e: (e.submitted_at, e.request_id))
        return out

    # -- versioned-put transitions ------------------------------------------
    _ANY_OWNER = object()       # sentinel: skip the ownership guard

    def transition(self, request_id: str, to: RequestStatus, *,
                   expected_version: int | None = None,
                   if_owner=_ANY_OWNER,
                   **fields) -> LedgerEntry:
        """Compare-and-swap the record to status ``to``.

        ``expected_version`` (when given) must match the stored version;
        ``if_owner`` (when given — ``None`` means *must be unowned*)
        must match the stored ownership token. Extra ``fields``
        overwrite entry attributes in the same put. Raises
        ``LedgerConflict`` when the swap loses.
        """
        with _LEDGER_LOCK:
            entry = self._read(request_id)
            if entry is None:
                raise LedgerConflict(f"request {request_id} not found")
            if expected_version is not None \
                    and entry.version != expected_version:
                raise LedgerConflict(
                    f"request {request_id}: version {entry.version} != "
                    f"expected {expected_version}")
            if if_owner is not RequestLedger._ANY_OWNER \
                    and entry.owner != if_owner:
                raise LedgerConflict(
                    f"request {request_id}: owned by {entry.owner}, "
                    f"not {if_owner}")
            if to not in _ALLOWED[entry.status]:
                raise LedgerConflict(
                    f"request {request_id}: illegal transition "
                    f"{entry.status.value} → {to.value}")
            entry.status = to
            entry.version += 1
            for k, v in fields.items():
                setattr(entry, k, v)
            if to is RequestStatus.RUNNING and entry.started_at is None:
                entry.started_at = time.time()
            if to.terminal:
                entry.finished_at = time.time()
                entry.owner = None
                entry.lease_expires = 0.0
            if to is RequestStatus.QUEUED:     # re-queue: drop ownership
                entry.owner = None
                entry.lease_expires = 0.0
            self._write(entry)
            # chaos: the service instance dies right after the CAS
            # landed this transition — the entry is consistent but the
            # owner is gone; lease expiry must hand it to a peer
            chaos = getattr(self.store, "chaos", None)
            if chaos is not None:
                chaos.kill_once(f"ledger.{to.value}")
            return entry

    # -- ownership / leases --------------------------------------------------
    def claim(self, request_id: str, owner: str) -> LedgerEntry | None:
        """QUEUED → ADMITTED under ``owner``'s lease; None if the swap
        lost (someone else admitted it, or it is no longer QUEUED —
        only QUEUED → ADMITTED is a legal transition, so the status
        check rides on the transition table)."""
        try:
            return self.transition(
                request_id, RequestStatus.ADMITTED,
                if_owner=None,  # guard: only unowned entries claimable
                owner=owner,
                lease_expires=time.time() + self.lease_ttl_s)
        except LedgerConflict:
            return None

    def renew_lease(self, request_id: str, owner: str) -> bool:
        """Extend the owner's lease on a live entry; False if lost.

        An *expired* lease cannot be renewed even by its original owner:
        once the deadline passed, ``recover_expired`` may already have
        handed the request to a peer (or is about to) — a slow-but-alive
        owner renewing after expiry would resurrect ownership it no
        longer holds and run the query twice. The owner must treat the
        False as a fencing signal and drop the request."""
        with _LEDGER_LOCK:
            entry = self._read(request_id)
            if entry is None or entry.owner != owner \
                    or entry.status.terminal \
                    or entry.lease_expires < time.time():
                return False
            entry.version += 1
            entry.lease_expires = time.time() + self.lease_ttl_s
            self._write(entry)
            return True

    def recover_expired(self) -> list[LedgerEntry]:
        """Re-queue every ADMITTED/RUNNING entry whose lease expired
        (owner died mid-flight); returns the re-queued entries."""
        now = time.time()
        recovered = []
        for entry in self.entries():
            if entry.status in (RequestStatus.ADMITTED,
                                RequestStatus.RUNNING) \
                    and entry.lease_expires < now:
                try:
                    recovered.append(self.transition(
                        entry.request_id, RequestStatus.QUEUED,
                        expected_version=entry.version,
                        attempt=entry.attempt + 1))
                except LedgerConflict:
                    pass    # someone else recovered (or finished) it
        return recovered

    # -- notifications -------------------------------------------------------
    def version_token(self, request_id: str) -> str | None:
        return self.store.version(self._key(request_id))

    def watch(self, request_id: str, token: str | None = None, *,
              timeout_s: float | None = None,
              cancel_check=None) -> str | None:
        """Block until the record changes (store watch primitive)."""
        return self.store.watch(self._key(request_id), token,
                                timeout_s=timeout_s,
                                cancel_check=cancel_check)
