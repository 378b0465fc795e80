"""Serverless object store abstraction (Amazon S3 analog).

Immutable binary objects addressed by string keys, with ranged reads,
per-request simulated latency draws (tier models from ``tiers.py``), and
cost accounting. Backends: in-memory (tests, single process) and local
filesystem (shared across processes).

Workers in Skyrise communicate *only* through this store; object writes are
atomic and last-writer-wins, which together with deterministic worker outputs
makes re-triggering and racing duplicate workers safe (paper section 3.3).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
import uuid
from typing import Callable, Iterable

import numpy as np

from repro_torch.storage.tiers import TIERS, StorageTier


def _transient(msg: str) -> Exception:
    # Lazy import: the storage layer must not trigger the repro_torch.core
    # package init at module-import time (core → sql → data → storage
    # would cycle). sys.modules caching makes the per-call cost a dict
    # lookup; fault paths are rare anyway.
    from repro_torch.core.retry import TransientInfraError
    return TransientInfraError(msg)

# Watch (version-polling) backoff: polling a key's version is a HEAD
# analog — free — but each poll is a syscall/lock acquisition, so waiters
# back off exponentially between polls. The cap doubles as the
# cancel-check interval, so a cancelled waiter never sleeps longer.
WATCH_BACKOFF_INITIAL_S = 0.002
WATCH_BACKOFF_MAX_S = 0.05


@dataclasses.dataclass
class RequestResult:
    """Outcome of a single storage request (one HTTP round trip analog)."""

    data: bytes | None
    sim_latency_s: float
    cost_cents: float
    nbytes: int


@dataclasses.dataclass
class StoreStats:
    get_requests: int = 0
    put_requests: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    cost_cents: float = 0.0
    sim_latency_s: float = 0.0

    def merge(self, other: "StoreStats") -> None:
        self.get_requests += other.get_requests
        self.put_requests += other.put_requests
        self.bytes_read += other.bytes_read
        self.bytes_written += other.bytes_written
        self.cost_cents += other.cost_cents
        self.sim_latency_s += other.sim_latency_s


class Backend:
    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str, rng: tuple[int, int] | None) -> bytes:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def etag(self, key: str) -> str:
        """Opaque version token; changes whenever the object's bytes may
        have changed (the S3 ETag analog). Used by metadata caches."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Move ``src`` to ``dst`` (atomic where the backend allows it) —
        the commit step of torn-write-protected puts."""
        data = self.get(src, None)
        self.put(dst, data)
        self.delete(src)

    def put_if_version(self, key: str, data: bytes,
                       expected: str | None) -> bool:
        """Conditional put: lands only if the key's current version
        equals ``expected`` (None = key absent). Returns True iff the
        write landed. Base implementation is check-then-put — atomic
        enough for single-process backends only; backends with an
        in-process lock override with a real compare-and-swap."""
        if self.version(key) != expected:
            return False
        self.put(key, data)
        return True

    # -- watch/notify seam -------------------------------------------------
    def version(self, key: str) -> str | None:
        """The key's version token, or None while the key is absent —
        unlike ``etag``, never raises; absence is a observable state a
        watcher can wait on (claim deleted, entry not yet written)."""
        try:
            return self.etag(key)
        except (KeyError, FileNotFoundError, OSError):
            return None

    def watch(self, key: str, token: str | None, deadline: float,
              cancel_check: Callable[[], None] | None = None) -> str | None:
        """Block until ``key``'s version differs from ``token`` or the
        monotonic ``deadline`` passes; returns the current version.

        Base implementation: version polling with exponential backoff
        (shared-filesystem stores have no notification channel).
        Backends with an in-process write path override this with a
        notify-on-put wait. ``cancel_check`` is polled between sleeps
        and may raise to abort the wait.
        """
        delay = WATCH_BACKOFF_INITIAL_S
        while True:
            cur = self.version(key)
            if cur != token:
                return cur
            now = time.monotonic()
            if now >= deadline:
                return cur
            if cancel_check is not None:
                cancel_check()
            time.sleep(min(delay, deadline - now))
            delay = min(delay * 2, WATCH_BACKOFF_MAX_S)


class MemoryBackend(Backend):
    """Dict-backed store; thread-safe; shared within one process."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._versions: dict[str, int] = {}
        self._lock = threading.Lock()
        # watch/notify: every put/delete wakes watchers instantly, so
        # in-process waiters never pay the polling backoff
        self._watch_cv = threading.Condition(self._lock)

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)
            self._versions[key] = self._versions.get(key, 0) + 1
            self._watch_cv.notify_all()

    def get(self, key: str, rng: tuple[int, int] | None) -> bytes:
        with self._lock:
            obj = self._objects[key]
        if rng is None:
            return obj
        off, length = rng
        return obj[off:off + length]

    def size(self, key: str) -> int:
        with self._lock:
            return len(self._objects[key])

    def etag(self, key: str) -> str:
        with self._lock:
            if key not in self._objects:
                raise KeyError(key)
            return f"v{self._versions[key]}-{len(self._objects[key])}"

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def list(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)
            self._watch_cv.notify_all()

    def rename(self, src: str, dst: str) -> None:
        with self._lock:
            data = self._objects.pop(src)
            self._versions.pop(src, None)
            self._objects[dst] = data
            self._versions[dst] = self._versions.get(dst, 0) + 1
            self._watch_cv.notify_all()

    def put_if_version(self, key: str, data: bytes,
                       expected: str | None) -> bool:
        # real CAS: version check and write under one lock acquisition
        with self._lock:
            cur = (f"v{self._versions[key]}-{len(self._objects[key])}"
                   if key in self._objects else None)
            if cur != expected:
                return False
            self._objects[key] = bytes(data)
            self._versions[key] = self._versions.get(key, 0) + 1
            self._watch_cv.notify_all()
            return True

    def watch(self, key: str, token: str | None, deadline: float,
              cancel_check: Callable[[], None] | None = None) -> str | None:
        with self._watch_cv:
            while True:
                cur = (f"v{self._versions[key]}-{len(self._objects[key])}"
                       if key in self._objects else None)
                if cur != token:
                    return cur
                now = time.monotonic()
                if now >= deadline:
                    return cur
                if cancel_check is not None:
                    cancel_check()
                # bounded wait: cancel_check stays responsive even if no
                # writer ever notifies
                self._watch_cv.wait(
                    timeout=min(WATCH_BACKOFF_MAX_S, deadline - now))


class FilesystemBackend(Backend):
    """Local-FS store; keys map to paths; atomic renames emulate S3 puts."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.join(self.root, key)
        if os.path.commonpath([os.path.abspath(path), self.root]) != \
                os.path.abspath(self.root):
            raise ValueError(f"key escapes store root: {key}")
        return path

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic, last-writer-wins
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get(self, key: str, rng: tuple[int, int] | None) -> bytes:
        with open(self._path(key), "rb") as f:
            if rng is None:
                return f.read()
            off, length = rng
            f.seek(off)
            return f.read(length)

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def etag(self, key: str) -> str:
        # the inode distinguishes rapid same-size overwrites that land
        # within one mtime tick: every put() replaces via a fresh temp
        # file, so the inode changes even when mtime_ns + size do not
        st = os.stat(self._path(key))
        return f"{st.st_ino}-{st.st_mtime_ns}-{st.st_size}"

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list(self, prefix: str) -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def rename(self, src: str, dst: str) -> None:
        dpath = self._path(dst)
        os.makedirs(os.path.dirname(dpath), exist_ok=True)
        os.replace(self._path(src), dpath)  # atomic on one filesystem


class ObjectStore:
    """A keyed object store with a tier latency/cost model attached.

    Multiple ObjectStore views (different tiers) may share one backend —
    Skyrise tiers shuffle data to hotter storage while table data stays on
    the standard tier (paper sections 3.2, 5.1).
    """

    def __init__(self, backend: Backend | None = None,
                 tier: str | StorageTier = "s3-standard",
                 seed: int = 0) -> None:
        self.backend = backend if backend is not None else MemoryBackend()
        self.tier = TIERS[tier] if isinstance(tier, str) else tier
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self.stats = StoreStats()
        self._stats_lock = threading.Lock()
        self.chaos = None  # optional ChaosEngine injecting storage faults

    # -- tier views --------------------------------------------------------
    def with_tier(self, tier: str | StorageTier) -> "ObjectStore":
        view = ObjectStore.__new__(ObjectStore)
        view.backend = self.backend
        view.tier = TIERS[tier] if isinstance(tier, str) else tier
        view._rng = self._rng
        view._rng_lock = self._rng_lock
        view.stats = self.stats        # shared accounting
        view._stats_lock = self._stats_lock
        view.chaos = self.chaos        # shared fault schedule
        return view

    # -- chaos -------------------------------------------------------------
    def _chaos(self):
        """The attached chaos engine, or None. The KV tier is exempt
        from random storage faults (conditional writes are atomic in the
        modeled backend); its failure modes are the explicit protocol
        kill points instead."""
        ch = self.chaos
        if ch is None or self.tier.name == "dynamodb":
            return None
        return ch

    # -- accounting --------------------------------------------------------
    def _account(self, *, write: bool, nbytes: int,
                 scale: float = 1.0) -> tuple[float, float]:
        with self._rng_lock:
            latency = self.tier.draw_latency_s(self._rng, write=write,
                                               nbytes=nbytes) * scale
        cost = self.tier.request_cost_cents(write=write, nbytes=nbytes)
        with self._stats_lock:
            if write:
                self.stats.put_requests += 1
                self.stats.bytes_written += nbytes
            else:
                self.stats.get_requests += 1
                self.stats.bytes_read += nbytes
            self.stats.cost_cents += cost
            self.stats.sim_latency_s += latency
        return latency, cost

    # -- object API --------------------------------------------------------
    def put(self, key: str, data: bytes) -> RequestResult:
        ch = self._chaos()
        scale = 1.0
        if ch is not None:
            fault = ch.storage_fault("put", key)
            if fault == "transient":
                raise _transient(
                    f"chaos: transient PUT failure for {key}")
            if fault == "throttle":
                # 503 SlowDown: the round trip happened and its latency
                # is billed, but no bytes landed
                with self._stats_lock:
                    self.stats.sim_latency_s += ch.config.throttle_latency_s
                raise _transient(f"chaos: 503 SlowDown on PUT {key}")
            if fault == "torn":
                # sandbox died mid-PUT: a strict prefix of the bytes
                # lands under the key, and nobody cleans it up
                self.backend.put(key, bytes(data)[:max(1, len(data) // 2)])
                raise _transient(
                    f"chaos: sandbox died mid-PUT of {key} (torn object)")
            scale = ch.latency_scale("put")
        self.backend.put(key, data)
        latency, cost = self._account(write=True, nbytes=len(data),
                                      scale=scale)
        return RequestResult(None, latency, cost, len(data))

    def put_committed(self, key: str, data: bytes) -> RequestResult:
        """Torn-write-protected put: write to a temp key, validate that
        every byte landed (etag/size check), then commit with an atomic
        rename. A producer killed mid-PUT leaves only an orphaned temp
        object under ``_tmp/`` — a readable partial object never appears
        at the final key. Billed as the data PUT; the commit rename is a
        metadata operation (S3 COPY analog on the same backend, not a
        second data round trip)."""
        data = bytes(data)
        tmp = f"_tmp/{uuid.uuid4().hex}"
        res = self.put(tmp, data)  # chaos may fail or tear THIS write
        # etag-validated commit: confirm the temp object is whole before
        # it becomes visible under the final key
        if self.backend.version(tmp) is None \
                or self.backend.size(tmp) != len(data):
            self.backend.delete(tmp)
            raise _transient(
                f"chaos: torn temp object detected before commit of {key}")
        ch = self._chaos()
        if ch is not None:
            # optional kill point: death after upload, before commit —
            # the final key must stay absent
            ch.kill_once("storage.commit")
        self.backend.rename(tmp, key)
        return RequestResult(None, res.sim_latency_s, res.cost_cents,
                             len(data))

    def put_if_version(self, key: str, data: bytes,
                       expected: str | None) -> bool:
        """Conditional put (DynamoDB conditional-write analog): lands
        only if the key's current version equals ``expected`` (None =
        absent). Returns True iff the write landed; billed as one PUT
        either way (the request happens, condition or not)."""
        data = bytes(data)
        ok = self.backend.put_if_version(key, data, expected)
        self._account(write=True, nbytes=len(data))
        return ok

    def get(self, key: str,
            rng: tuple[int, int] | None = None) -> RequestResult:
        ch = self._chaos()
        scale = 1.0
        if ch is not None:
            fault = ch.storage_fault("get", key)
            if fault == "transient":
                raise _transient(
                    f"chaos: transient GET failure for {key}")
            if fault == "throttle":
                with self._stats_lock:
                    self.stats.sim_latency_s += ch.config.throttle_latency_s
                raise _transient(f"chaos: 503 SlowDown on GET {key}")
            scale = ch.latency_scale("get")
        data = self.backend.get(key, rng)
        latency, cost = self._account(write=False, nbytes=len(data),
                                      scale=scale)
        return RequestResult(data, latency, cost, len(data))

    def size(self, key: str) -> int:
        return self.backend.size(key)

    def etag(self, key: str) -> str:
        """Version token for ``key`` (HEAD analog; not a billed request)."""
        return self.backend.etag(key)

    def version(self, key: str) -> str | None:
        """Like ``etag`` but None for an absent key (never raises)."""
        return self.backend.version(key)

    def watch(self, key: str, token: str | None = None, *,
              timeout_s: float | None = None,
              cancel_check: Callable[[], None] | None = None) -> str | None:
        """Block until ``key``'s version differs from ``token``.

        The store-level notification primitive (DynamoDB-streams / etcd
        watch analog): waiters observe a version token with ``version``,
        then ``watch`` until a writer changes (or deletes/creates) the
        key. Returns the current version — equal to ``token`` iff the
        wait timed out. Memory backends wake watchers on every put and
        delete; filesystem backends fall back to version polling with
        exponential backoff. Version reads are HEAD analogs: no billed
        KV requests are issued while waiting.
        """
        deadline = time.monotonic() + (3600.0 if timeout_s is None
                                       else max(timeout_s, 0.0))
        return self.backend.watch(key, token, deadline, cancel_check)

    def exists(self, key: str) -> bool:
        return self.backend.exists(key)

    def list(self, prefix: str = "") -> list[str]:
        return self.backend.list(prefix)

    def delete(self, key: str) -> None:
        self.backend.delete(key)

    def delete_prefix(self, prefix: str) -> None:
        for key in self.list(prefix):
            self.backend.delete(key)

    def total_bytes(self, keys: Iterable[str]) -> int:
        return sum(self.size(k) for k in keys)
