"""The port's query service tier (``repro_torch.service``) against the
reference's: each case of ``tests/test_service.py`` runs the same scenario
through ``repro`` and through ``repro_torch`` (fragments on the CPU) and
compares the two — sorted rows within rtol = atol = 1e-9, statuses,
attempts and invocation counts exactly. A lease never expires by waiting:
the ``time`` name inside each package's ``service.ledger`` is replaced by
a clock the test moves (``clock``), so the recovery cases do not race
their own lease renewals under load."""

import dataclasses
import importlib
import threading
import time
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest

from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import msgpack_codec as codec

TOL = dict(rtol=1e-9, atol=1e-9)
LEASE_S = 30.0          # every lease here outlives the run; the clock
# moves past it where a case needs an owner's lease to have lapsed


def _pkg(name, **connect_kw):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        name=name, api=mod("api"), svc=mod("service"),
        ledger=mod("service.ledger"), cost=mod("core.cost"),
        engine=mod("core.engine"), platform=mod("core.platform"),
        worker=mod("core.worker"), data=mod("data"),
        physical=mod("sql.physical"), storage=mod("storage"),
        kw=connect_kw)


REF = _pkg("repro")
PORT = _pkg("repro_torch", device="cpu")
PKGS = (REF, PORT)


def _cfg(pkg, **kw):
    return pkg.engine.CoordinatorConfig(planner=pkg.physical.PlannerConfig(
        bytes_per_worker=250_000, broadcast_threshold_bytes=150_000,
        exchange_partitions=3), **kw)


def _connect(pkg, *args, **kw):
    return pkg.api.connect(*args, **kw, **pkg.kw)


def _fresh_db(pkg, seed=0, n_parts=4):
    store = pkg.storage.ObjectStore(tier="local", seed=seed)
    catalog = pkg.data.generate_tpch(store, sf=0.01, n_parts=n_parts,
                                     seed=0)
    return store, catalog


def _service(pkg, store, catalog, *, tenants=(), quota=16,
             lease_ttl_s=LEASE_S, start=True):
    platform = pkg.platform.FaasPlatform(quota=quota, seed=0)
    session = _connect(pkg, store, catalog, platform=platform,
                       config=_cfg(pkg), max_concurrent_queries=4)
    svc = pkg.svc.QueryService(session, tenants=tuple(tenants),
                               lease_ttl_s=lease_ttl_s, start=start)
    return svc, session


def _solo_invocations(pkg, sql):
    """Worker invocations one clean execution of ``sql`` needs."""
    store, catalog = _fresh_db(pkg)
    platform = pkg.platform.FaasPlatform(quota=16, seed=0)
    with _connect(pkg, store, catalog, platform=platform, config=_cfg(pkg),
                  max_concurrent_queries=4) as session:
        session.sql(sql)
    return platform.invocations


def _sorted_rows(cols):
    keys = sorted(cols)
    arrs = [np.asarray(cols[k], np.float64) for k in keys]
    order = np.lexsort(arrs)
    return {k: a[order] for k, a in zip(keys, arrs)}


def _assert_same_rows(a, b, ctx):
    sa, sb = _sorted_rows(a), _sorted_rows(b)
    assert sorted(sa) == sorted(sb), ctx
    for k in sa:
        np.testing.assert_allclose(sa[k], sb[k], err_msg=f"{ctx} :: {k}",
                                   **TOL)


def _both(scenario, *args):
    """``scenario(pkg, *args)`` for the reference, then the port; the two
    observations (rows aside) must be equal."""
    ref, port = (scenario(pkg, *args) for pkg in PKGS)
    ref_rows, port_rows = ref.pop("rows", None), port.pop("rows", None)
    assert port == ref
    if ref_rows is not None:
        for i, (a, b) in enumerate(zip(port_rows, ref_rows)):
            _assert_same_rows(a, b, f"{scenario.__name__} result {i}")
    return ref, port, port_rows


class _Clock:
    """Stands in for the ``time`` module inside a ledger module: the wall
    clock plus an offset that the test moves."""

    def __init__(self):
        self.offset = 0.0

    def time(self):
        return time.time() + self.offset

    def advance(self, seconds):
        self.offset += seconds


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for pkg in PKGS:
        monkeypatch.setattr(pkg.ledger, "time", c)
    return c


@pytest.fixture(scope="module")
def stores():
    """One TPC-H SF 0.01 store a package, shared by the cases that use
    the reference's session-wide ``tpch_store`` (result cache included)."""
    return {pkg.name: _fresh_db(pkg) for pkg in PKGS}


_ORACLE = {}


def _oracle(sql):
    """The port's numpy oracle on SF 0.01 (the data both packages make)."""
    if sql not in _ORACLE:
        store, catalog = _fresh_db(PORT)
        ih = PORT.storage.InputHandler(store)
        tables = {}
        for name, meta in catalog.tables.items():
            parts = [ih.read_table(f)[0] for f in meta.files]
            tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                            for c in meta.schema}
        lqp, _ = Binder(catalog).bind(parse(sql))
        _ORACLE[sql] = oracle.run(optimize(lqp), tables)
    return _ORACLE[sql]


# -- store-level watch primitive ------------------------------------------------

def _watch_store(pkg, backend, tmp_path):
    if backend == "fs":
        return pkg.storage.ObjectStore(pkg.storage.FilesystemBackend(
            str(tmp_path / pkg.name / "store")), tier="local", seed=0)
    return pkg.storage.ObjectStore(tier="local", seed=0)


@pytest.mark.parametrize("backend", ["memory", "fs"])
def test_watch_wakes_on_put(backend, tmp_path):
    def scenario(pkg):
        store = _watch_store(pkg, backend, tmp_path)
        store.put("w/k", b"v1")
        token = store.version("w/k")
        woke = []
        t = threading.Thread(target=lambda: woke.append(
            store.watch("w/k", token, timeout_s=10.0)))
        t.start()
        time.sleep(0.05)
        store.put("w/k", b"v2")
        t.join(timeout=10.0)
        return {"alive": t.is_alive(),
                "changed": bool(woke) and woke[0] != token}
    ref, _, _ = _both(scenario)
    assert ref == {"alive": False, "changed": True}


@pytest.mark.parametrize("backend", ["memory", "fs"])
def test_watch_observes_create_and_delete(backend, tmp_path):
    def scenario(pkg):
        store = _watch_store(pkg, backend, tmp_path)
        absent = store.version("w/absent")
        store.put("w/absent", b"x")
        created = store.watch("w/absent", None, timeout_s=0.5)
        token = store.version("w/absent")
        store.delete("w/absent")
        deleted = store.watch("w/absent", token, timeout_s=5.0)
        return {"absent": absent, "created": created is not None,
                "deleted": deleted}
    ref, _, _ = _both(scenario)
    assert ref == {"absent": None, "created": True, "deleted": None}


def test_watch_timeout_returns_unchanged_token():
    def scenario(pkg):
        store = pkg.storage.ObjectStore(tier="local", seed=0)
        store.put("w/t", b"v")
        token = store.version("w/t")
        t0 = time.monotonic()
        same = store.watch("w/t", token, timeout_s=0.1) == token
        return {"same": same, "prompt": time.monotonic() - t0 < 2.0}
    ref, _, _ = _both(scenario)
    assert ref == {"same": True, "prompt": True}


def test_watch_cancel_check_aborts_wait():
    class _Stop(Exception):
        pass

    def cancel():
        raise _Stop

    def scenario(pkg):
        store = pkg.storage.ObjectStore(tier="local", seed=0)
        store.put("w/c", b"v")
        with pytest.raises(_Stop):
            store.watch("w/c", store.version("w/c"), timeout_s=30.0,
                        cancel_check=cancel)
        return {}
    _both(scenario)


# -- ledger: CAS transitions ----------------------------------------------------

def _ledger(pkg, lease_ttl_s=LEASE_S):
    return pkg.svc.RequestLedger(pkg.storage.ObjectStore(tier="local",
                                                         seed=0),
                                 lease_ttl_s=lease_ttl_s)


def _view(e):
    return None if e is None else (e.status.value, e.version, e.owner,
                                   e.attempt)


def _served(e):
    """An entry a service ran: its version also counts the dispatcher's
    lease renewals, which depend on timing, so it is left out."""
    return (e.status.value, e.owner, e.attempt)


def test_ledger_lifecycle_and_versioning(clock):
    def scenario(pkg):
        RS = pkg.svc.RequestStatus
        led = _ledger(pkg)
        e = led.submit("select 1", tenant="t", priority=2, deadline_s=9.0)
        assert e.status is RS.QUEUED and e.version == 1
        got = led.get(e.request_id)
        assert got.sql == "select 1" and got.tenant == "t"
        assert got.priority == 2 and got.deadline_s == 9.0
        claimed = led.claim(e.request_id, "svc-a")
        assert claimed.lease_expires > clock.time()
        run = led.transition(e.request_id, RS.RUNNING, if_owner="svc-a")
        assert run.started_at is not None
        done = led.transition(e.request_id, RS.SUCCEEDED,
                              if_owner="svc-a", result={"rows": 1})
        assert done.finished_at is not None
        return {"trace": [_view(x) for x in (e, claimed, run, done)],
                "result": done.result}
    ref, _, _ = _both(scenario)
    assert ref["trace"] == [("QUEUED", 1, None, 0),
                            ("ADMITTED", 2, "svc-a", 0),
                            ("RUNNING", 3, "svc-a", 0),
                            ("SUCCEEDED", 4, None, 0)]
    assert ref["result"] == {"rows": 1}


def test_ledger_rejects_duplicate_stale_foreign_and_illegal(clock):
    def scenario(pkg):
        RS, Conflict = pkg.svc.RequestStatus, pkg.svc.LedgerConflict
        led = _ledger(pkg)
        led.submit("q", request_id="r1")
        refused = []

        def refuse(label, fn, *a, **kw):
            with pytest.raises(Conflict):
                fn(*a, **kw)
            refused.append(label)
        refuse("duplicate", led.submit, "q2", request_id="r1")
        led.claim("r1", "svc-a")
        refuse("stale", led.transition, "r1", RS.RUNNING,
               expected_version=1)
        refuse("foreign", led.transition, "r1", RS.RUNNING,
               if_owner="svc-b")
        refuse("illegal", led.transition, "r1", RS.SUCCEEDED,
               if_owner="svc-a")
        led.transition("r1", RS.RUNNING, if_owner="svc-a")
        led.transition("r1", RS.SUCCEEDED, if_owner="svc-a")
        refuse("terminal", led.transition, "r1", RS.QUEUED)
        late_claim = led.claim("r1", "svc-b")
        refuse("unknown", led.transition, "ghost", RS.CANCELLED)
        return {"refused": refused, "late_claim": late_claim,
                "final": _view(led.get("r1"))}
    ref, _, _ = _both(scenario)
    assert ref["late_claim"] is None
    assert ref["final"] == ("SUCCEEDED", 4, None, 0)


def test_ledger_double_claim_single_winner(clock):
    def scenario(pkg):
        led = _ledger(pkg)
        led.submit("q", request_id="r")
        wins = [led.claim("r", f"svc-{i}") is not None for i in range(4)]
        return {"wins": wins, "owner": led.get("r").owner}
    ref, _, _ = _both(scenario)
    assert ref == {"wins": [True, False, False, False], "owner": "svc-0"}


def test_ledger_lease_expiry_requeues_and_bumps_attempt(clock):
    def scenario(pkg):
        led = _ledger(pkg, lease_ttl_s=0.05)
        led.submit("q", request_id="r")
        led.claim("r", "svc-dead")
        live = led.recover_expired()
        clock.advance(0.1)                     # the owner never renews
        recovered = [e.request_id for e in led.recover_expired()]
        after = _view(led.get("r"))
        dead_renews = led.renew_lease("r", "svc-dead")
        led.claim("r", "svc-live")
        live_renews = led.renew_lease("r", "svc-live")
        kept = led.recover_expired()
        clock.advance(0.1)                     # now even the live owner
        late_renews = led.renew_lease("r", "svc-live")   # is fenced
        again = [e.request_id for e in led.recover_expired()]
        return {"live": live, "recovered": recovered, "after": after,
                "dead_renews": dead_renews, "live_renews": live_renews,
                "kept": kept, "late_renews": late_renews, "again": again,
                "final": _view(led.get("r"))}
    ref, _, _ = _both(scenario)
    assert ref == {"live": [], "recovered": ["r"],
                   "after": ("QUEUED", 3, None, 1), "dead_renews": False,
                   "live_renews": True, "kept": [], "late_renews": False,
                   "again": ["r"], "final": ("QUEUED", 6, None, 2)}


def test_ledger_entries_filters_and_orders(clock):
    def scenario(pkg):
        led = _ledger(pkg)
        led.submit("a", request_id="ra", tenant="t1")
        led.submit("b", request_id="rb", tenant="t2")
        led.submit("c", request_id="rc", tenant="t1")
        led.claim("rb", "svc")
        return {"all": [e.request_id for e in led.entries()],
                "t1": [e.request_id for e in led.entries(tenant="t1")],
                "admitted": [e.request_id for e in led.entries(
                    status=pkg.svc.RequestStatus.ADMITTED)]}
    ref, _, _ = _both(scenario)
    assert ref == {"all": ["ra", "rb", "rc"], "t1": ["ra", "rc"],
                   "admitted": ["rb"]}


def test_ledger_watch_wakes_handle_waiters(clock):
    def scenario(pkg):
        led = _ledger(pkg)
        led.submit("q", request_id="r")
        token = led.version_token("r")
        led.claim("r", "svc")
        return {"woke": led.watch("r", token, timeout_s=5.0) != token}
    ref, _, _ = _both(scenario)
    assert ref == {"woke": True}


def _entry_fields(pkg, full):
    """A LedgerEntry with every field set (a result pointer of every value
    type the service writes, dependencies, a None), or the defaults."""
    if not full:
        return pkg.ledger.LedgerEntry(request_id="r0", sql="select 1")
    return pkg.ledger.LedgerEntry(
        request_id="dag-0a1b2c3d-n1", sql=QUERIES["q6"], tenant="gold",
        priority=-3, deadline_s=12.5,
        status=pkg.svc.RequestStatus.SUCCEEDED, version=7, owner=None,
        lease_expires=0.0, submitted_at=1760700000.25,
        started_at=1760700001.5, finished_at=1760700002.75, attempt=2,
        result={"locations": ["results/ab12/f0000/out.spax",
                              "results/ab12/f0001/out.spax"],
                "output_names": ["revenue"], "cost_cents": 0.0038465,
                "sim_latency_s": 0.4369805, "cache_hits": 3, "deduped": 1,
                "deadline_missed": False, "pipelined_pipelines": 0,
                "overlap_saved_s": 0.0},
        error=None, dag_id="dag-0a1b2c3d",
        depends_on=["dag-0a1b2c3d-n0", "r-" + "x" * 40])


@pytest.mark.parametrize("full", [True, False], ids=["every-field",
                                                     "defaults"])
def test_ledger_entry_bytes_equal_msgpack_and_read_across(full):
    """The port's ledger record is msgpack's bytes of the reference's
    record, and each package's ``from_dict`` reads the other's."""
    ref_e, port_e = _entry_fields(REF, full), _entry_fields(PORT, full)
    assert port_e.to_dict() == ref_e.to_dict()
    want = msgpack.packb(ref_e.to_dict())
    # the bytes the port's ledger writes, through its own store
    led = PORT.svc.RequestLedger(PORT.storage.ObjectStore(tier="local",
                                                          seed=0))
    led._write(port_e)
    got = led.store.get(led._key(port_e.request_id)).data
    assert got == want == codec.packb(port_e.to_dict())
    back_ref = REF.ledger.LedgerEntry.from_dict(msgpack.unpackb(got))
    back_port = PORT.ledger.LedgerEntry.from_dict(codec.unpackb(want))
    assert dataclasses.asdict(back_ref) == dataclasses.asdict(ref_e)
    assert dataclasses.asdict(back_port) == dataclasses.asdict(port_e)
    assert back_port.status is PORT.svc.RequestStatus(ref_e.status.value)
    assert led.get(port_e.request_id).to_dict() == ref_e.to_dict()


# -- service: end-to-end --------------------------------------------------------

def test_service_executes_and_persists_result(stores):
    def scenario(pkg):
        store, catalog = stores[pkg.name]
        svc, session = _service(pkg, store, catalog)
        try:
            h = svc.submit(QUERIES["q6"])
            cols = h.result(timeout=300).fetch(store)
            entry = h.entry()
            assert entry.finished_at is not None
            assert entry.result["locations"] or entry.result["cache_hits"]
            again = pkg.svc.ServiceHandle(h.request_id, svc).fetch(
                timeout=10)
            np.testing.assert_allclose(again["revenue"], cols["revenue"])
            return {"status": entry.status.value, "owner": entry.owner,
                    "attempt": entry.attempt, "n": len(cols["revenue"]),
                    "invocations": session.platform.invocations,
                    "rows": [cols]}
        finally:
            svc.close()
            session.close()
    ref, _, rows = _both(scenario)
    assert ref == {"status": "SUCCEEDED", "owner": None, "attempt": 0,
                   "n": 1, "invocations": ref["invocations"]}
    assert ref["invocations"] > 0
    _assert_same_rows(rows[0], _oracle(QUERIES["q6"]), "q6 vs oracle")


def test_service_records_failure_and_cancel(stores):
    def scenario(pkg):
        store, catalog = stores[pkg.name]
        svc, session = _service(pkg, store, catalog)
        try:
            bad = svc.submit("select no_such_col from lineitem")
            with pytest.raises(pkg.svc.RequestFailed):
                bad.result(timeout=120)
            assert bad.entry().error
            svc.kill()
            queued = svc.submit(QUERIES["q1"])
            cancelled = queued.cancel()
            with pytest.raises(pkg.engine.QueryCancelled):
                queued.result(timeout=10)
            return {"bad": _served(bad.entry()), "cancelled": cancelled,
                    "queued": _view(queued.entry()),
                    "invocations": session.platform.invocations}
        finally:
            svc.close()
            session.close()
    ref, _, _ = _both(scenario)
    assert ref["bad"][0] == "FAILED" and ref["cancelled"]
    assert ref["queued"] == ("CANCELLED", 2, None, 0)
    assert ref["invocations"] == 0


# -- service: crash recovery ----------------------------------------------------

@pytest.mark.parametrize("die_at", ["ADMITTED", "RUNNING"])
def test_recovery_of_orphaned_entry_runs_fleet_exactly_once(die_at, clock):
    """An owner that died right after reaching ``die_at`` (before any
    worker ran) leaves an orphan; once its lease has lapsed, a fresh
    service re-queues it and runs it with one fleet's invocations."""
    def scenario(pkg):
        RS = pkg.svc.RequestStatus
        solo = _solo_invocations(pkg, QUERIES["q6"])
        store, catalog = _fresh_db(pkg)
        ledger = pkg.svc.RequestLedger(store, lease_ttl_s=LEASE_S)
        ledger.submit(QUERIES["q6"], request_id="r")
        ledger.claim("r", "svc-dead")
        if die_at == "RUNNING":
            ledger.transition("r", RS.RUNNING, if_owner="svc-dead")
        orphan = _view(ledger.get("r"))
        clock.advance(LEASE_S + 1)         # the owner never renews
        platform = pkg.platform.FaasPlatform(quota=16, seed=0)
        session = _connect(pkg, store, catalog, platform=platform,
                           config=_cfg(pkg), max_concurrent_queries=4)
        svc = pkg.svc.QueryService(session, ledger=ledger)
        try:
            h = pkg.svc.ServiceHandle("r", svc)
            entry = h.wait(timeout=120)
            cols = h.fetch(timeout=30)
            return {"orphan": orphan, "entry": _served(entry),
                    "recovered": svc.recovered_requests, "solo": solo,
                    "invocations": platform.invocations, "rows": [cols]}
        finally:
            svc.close()
            session.close()
    ref, _, rows = _both(scenario)
    assert ref["orphan"][:3] == (die_at, 2 if die_at == "ADMITTED" else 3,
                                 "svc-dead")
    assert ref["entry"] == ("SUCCEEDED", None, 1)
    assert ref["recovered"] == 1
    assert ref["invocations"] == ref["solo"] > 0   # exactly one execution
    _assert_same_rows(rows[0], _oracle(QUERIES["q6"]), "recovered q6")


def test_crash_mid_running_second_instance_no_duplicate_fleet(clock):
    """Kill the owning service while its query is RUNNING: the engine's
    published pipeline results make the second instance's re-run pure
    cache, so the platform sees one fleet's invocations in all."""
    def scenario(pkg):
        RS = pkg.svc.RequestStatus
        solo = _solo_invocations(pkg, QUERIES["q6"])
        store, catalog = _fresh_db(pkg)
        ledger = pkg.svc.RequestLedger(store, lease_ttl_s=LEASE_S)
        platform = pkg.platform.FaasPlatform(quota=16, seed=0)
        s1 = _connect(pkg, store, catalog, platform=platform,
                      config=_cfg(pkg), max_concurrent_queries=4)
        svc1 = pkg.svc.QueryService(s1, ledger=ledger)
        s2 = svc2 = None
        try:
            h = svc1.submit(QUERIES["q6"])
            deadline = time.monotonic() + 60
            while h.status() is not RS.RUNNING \
                    and not h.status().terminal \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            pre_kill = h.status().value
            svc1.kill()       # process death: the lease is orphaned
            s1.drain()        # the handed-off engine finishes, publishes
            clock.advance(LEASE_S + 1)
            s2 = _connect(pkg, store, catalog, platform=platform,
                          config=_cfg(pkg), max_concurrent_queries=4)
            svc2 = pkg.svc.QueryService(s2, ledger=ledger)
            entry = h.wait(timeout=120)
            cols = pkg.svc.ServiceHandle(h.request_id, svc2).fetch(
                timeout=30)
            return {"pre_kill": pre_kill, "entry": _served(entry),
                    "solo": solo, "invocations": platform.invocations,
                    "claims": s2.registry.claims, "rows": [cols]}
        finally:
            if svc2 is not None:
                svc2.close()
                s2.close()
            s1.close()
    ref, _, rows = _both(scenario)
    assert ref["pre_kill"] == "RUNNING"
    assert ref["entry"] == ("SUCCEEDED", None, 1)
    assert ref["invocations"] == ref["solo"] > 0   # no duplicate fleet
    assert ref["claims"] == 0                      # the re-run was cache
    _assert_same_rows(rows[0], _oracle(QUERIES["q6"]), "q6 after crash")


def test_restarted_service_resumes_queued_backlog(clock):
    def scenario(pkg):
        store, catalog = _fresh_db(pkg)
        ledger = pkg.svc.RequestLedger(store, lease_ttl_s=LEASE_S)
        platform = pkg.platform.FaasPlatform(quota=16, seed=0)
        s1 = _connect(pkg, store, catalog, platform=platform,
                      config=_cfg(pkg))
        svc1 = pkg.svc.QueryService(s1, ledger=ledger, start=False)
        h = svc1.submit(QUERIES["q6"])
        before = h.status().value
        s1.close()
        s2 = _connect(pkg, store, catalog, platform=platform,
                      config=_cfg(pkg), max_concurrent_queries=4)
        svc2 = pkg.svc.QueryService(s2, ledger=ledger)
        try:
            handle = pkg.svc.ServiceHandle(h.request_id, svc2)
            entry = handle.wait(timeout=120)
            return {"before": before, "entry": _served(entry),
                    "invocations": platform.invocations,
                    "rows": [handle.fetch(timeout=30)]}
        finally:
            svc2.close()
            s2.close()
            platform.close()
    ref, _, _ = _both(scenario)
    assert ref["before"] == "QUEUED"
    assert ref["entry"] == ("SUCCEEDED", None, 0)


# -- fair share -----------------------------------------------------------------

def test_fair_share_converges_to_weight_ratio():
    """Two groups flooding an 8-slot quota at weights 3:1: admitted slots
    converge to the weight ratio within ±20 %, in both packages."""
    def scenario(pkg):
        adm = pkg.platform.AdmissionController(
            8, shares={"gold": 3.0, "bronze": 1.0})
        stop = threading.Event()

        def flood(group):
            while not stop.is_set():
                got = adm.acquire(1, group=group)
                time.sleep(0.001)
                adm.release(got)

        threads = [threading.Thread(target=flood, args=(g,))
                   for g in ("gold", "bronze") for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join()
        admitted = adm.admitted_by_group
        assert admitted["gold"] > 0 and admitted["bronze"] > 0
        ratio = admitted["gold"] / admitted["bronze"]
        return {"within": 3.0 * 0.8 <= ratio <= 3.0 * 1.2}
    ref, _, _ = _both(scenario)
    assert ref == {"within": True}


def test_fair_share_unweighted_waiters_keep_priority_order():
    def scenario(pkg):
        adm = pkg.platform.AdmissionController(1, shares={"g": 2.0})
        hold = adm.acquire(1)
        order, lock = [], threading.Lock()

        def take(tag, prio):
            got = adm.acquire(1, priority=prio)
            with lock:
                order.append(tag)
            adm.release(got)

        threads = []
        for tag, prio in (("low", 0), ("high", 5)):
            t = threading.Thread(target=take, args=(tag, prio))
            t.start()
            threads.append(t)
            time.sleep(0.05)        # deterministic arrival order
        adm.release(hold)
        for t in threads:
            t.join()
        return {"first": order[0]}
    ref, _, _ = _both(scenario)
    assert ref == {"first": "high"}


def test_budget_throttles_then_window_rolls_over():
    def scenario(pkg):
        fair = pkg.svc.FairShareAdmission(
            pkg.platform.AdmissionController(4),
            (pkg.svc.TenantConfig("t", budget_cents=10.0,
                                  budget_window_s=0.3,
                                  degrade_fraction=0.8),))
        seen = [fair.admissible("t"), fair.degraded("t")]
        fair.charge("t", 9.0)                  # past 80 % → degraded
        seen += [fair.admissible("t"), fair.degraded("t")]
        fair.charge("t", 2.0)                  # past 100 % → throttled
        seen.append(fair.admissible("t"))
        time.sleep(0.35)                       # window rollover
        seen += [fair.admissible("t"), fair.degraded("t")]
        st = fair.stats()["t"]
        return {"seen": seen,
                "throttled": st["throttled_admissions"] >= 1,
                "degraded": st["degraded_dispatches"] >= 1,
                "lifetime": st["lifetime_cents"],
                "free": [fair.admissible(None), fair.admissible("ghost")]}
    ref, _, _ = _both(scenario)
    assert ref["seen"] == [True, False, True, True, False, True, False]
    assert ref["throttled"] and ref["degraded"]
    assert ref["lifetime"] == pytest.approx(11.0)
    assert ref["free"] == [True, True]


def test_service_throttles_over_budget_tenant_but_not_forever(stores):
    def scenario(pkg):
        store, catalog = stores[pkg.name]
        svc, session = _service(pkg, store, catalog, tenants=(
            pkg.svc.TenantConfig("broke", budget_cents=1e-6,
                                 budget_window_s=0.5),))
        try:
            svc.admission.charge("broke", 1.0)   # exhaust the window
            h = svc.submit(QUERIES["q6"], tenant="broke")
            time.sleep(0.15)
            held = h.status().value               # throttled
            entry = h.wait(timeout=300)           # the next window admits
            return {"held": held, "entry": _served(entry),
                    "throttled": svc.stats()["tenants"]["broke"][
                        "throttled_admissions"] >= 1,
                    "rows": [h.fetch(timeout=30)]}
        finally:
            svc.close()
            session.close()
    ref, _, _ = _both(scenario)
    assert ref == {"held": "QUEUED", "entry": ("SUCCEEDED", None, 0),
                   "throttled": True}


# -- DAGs -----------------------------------------------------------------------

def test_dag_validation_and_topological_order():
    def scenario(pkg):
        order = [pkg.svc.topological_order(3, {}),
                 pkg.svc.topological_order(3, {2: [0, 1], 1: [0]}),
                 pkg.svc.topological_order(3, {0: [2], 1: [0]}),
                 pkg.svc.topological_order(2, {0: [1], 1: [0]})]
        for n, deps in ((2, {0: [1], 1: [0]}), (2, {0: [0]}),
                        (2, {0: [5]}), (1, {3: []})):
            with pytest.raises(ValueError):
                pkg.svc.validate_dag(n, deps)
        return {"order": order}
    ref, _, _ = _both(scenario)
    assert ref == {"order": [[0, 1, 2], [0, 1, 2], [2, 0, 1], None]}


def test_dag_respects_depends_on_and_shares_subplans(stores):
    """node1 depends on node0 and holds the same plan: it starts only
    after node0 SUCCEEDED and re-executes no shared pipeline."""
    def scenario(pkg):
        store, catalog = stores[pkg.name]
        svc, session = _service(pkg, store, catalog)
        try:
            handles = svc.submit_dag([QUERIES["q6"], QUERIES["q6"]],
                                     {1: [0]})
            e1 = handles[1].wait(timeout=300)
            e0 = handles[0].entry()
            assert e0.dag_id == e1.dag_id
            assert e1.depends_on == [e0.request_id]
            assert e1.started_at >= e0.finished_at
            return {"status": [e0.status.value, e1.status.value],
                    "shared": e1.result["cache_hits"]
                    + e1.result["deduped"] >= 1,
                    "rows": [h.fetch(timeout=10) for h in handles]}
        finally:
            svc.close()
            session.close()
    ref, _, rows = _both(scenario)
    assert ref == {"status": ["SUCCEEDED", "SUCCEEDED"], "shared": True}
    _assert_same_rows(rows[0], rows[1], "dag nodes")


def test_dag_failed_dependency_fails_dependents(stores):
    def scenario(pkg):
        store, catalog = stores[pkg.name]
        svc, session = _service(pkg, store, catalog)
        try:
            handles = svc.submit_dag(
                ["select no_such_col from lineitem", QUERIES["q6"]],
                {1: [0]})
            for h in handles:
                with pytest.raises(pkg.svc.RequestFailed):
                    h.result(timeout=120)
            return {"status": [h.status().value for h in handles],
                    "dependency": "dependency" in handles[1].entry().error}
        finally:
            svc.close()
            session.close()
    ref, _, _ = _both(scenario)
    assert ref == {"status": ["FAILED", "FAILED"], "dependency": True}


# -- SLO deadlines → fleet sizing -----------------------------------------------

def test_stage_latency_budget_splits_remaining_deadline():
    def scenario(pkg):
        cm = pkg.cost.CostModel()
        return {"budgets": [cm.stage_latency_budget(10.0, 0.0, 2),
                            cm.stage_latency_budget(10.0, 6.0, 2),
                            cm.stage_latency_budget(10.0, 20.0, 2),
                            cm.stage_latency_budget(10.0, 0.0, 0)]}
    ref, _, _ = _both(scenario)
    assert ref["budgets"] == pytest.approx([5.0, 2.0, 0.001 / 2, 10.0])


def _scan_fleet(pkg, deadline_s=None, fleet_cap=None):
    store, catalog = _fresh_db(pkg)
    engine = pkg.engine.QueryEngine(
        store, catalog, platform=pkg.platform.FaasPlatform(quota=32, seed=0),
        config=pkg.engine.CoordinatorConfig(
            planner=pkg.physical.PlannerConfig(bytes_per_worker=30_000),
            use_result_cache=False),
        deadline_s=deadline_s, fleet_cap=fleet_cap,
        handler=pkg.worker.make_worker_handler(store, **pkg.kw))
    res = engine.execute_sql("select l_quantity from lineitem")
    return res.stats.pipelines


def test_tight_deadline_escalates_fleet():
    def scenario(pkg):
        return {"tight": _scan_fleet(pkg, deadline_s=0.01)[0].n_fragments,
                "loose": _scan_fleet(pkg, deadline_s=1e6)[0].n_fragments}
    ref, _, _ = _both(scenario)
    assert ref["tight"] >= ref["loose"] and ref["tight"] > 1


def test_fleet_cap_clamps_every_pipeline():
    def scenario(pkg):
        pipelines = _scan_fleet(pkg, fleet_cap=1)
        return {"fragments": [p.n_fragments for p in pipelines],
                "kinds": sorted({a["kind"] for p in pipelines
                                 for a in p.adaptations})}
    ref, _, _ = _both(scenario)
    assert set(ref["fragments"]) == {1}
    assert "deadline_fleet" in ref["kinds"]


def test_deadline_miss_is_recorded_by_service():
    def scenario(pkg):
        store, catalog = _fresh_db(pkg)     # a cache hit would meet any SLO
        svc, session = _service(pkg, store, catalog, tenants=(
            pkg.svc.TenantConfig("slo", deadline_s=1e-9),))
        try:
            h = svc.submit(QUERIES["q6"], tenant="slo")
            res = h.result(timeout=300)
            return {"missed": res.deadline_missed,
                    "misses": svc.stats()["deadline_misses"],
                    "deadline": h.entry().deadline_s,
                    "invocations": session.platform.invocations,
                    "rows": [res.fetch(store)]}
        finally:
            svc.close()
            session.close()
    ref, _, _ = _both(scenario)
    assert ref["missed"] is True and ref["misses"] == 1
    assert ref["deadline"] == 1e-9
