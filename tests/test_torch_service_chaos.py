"""Instance death in the port's service tier, against the reference's: the
ledger kill points and the fenced late lease renewal of
``tests/test_chaos.py``, and a dispatcher that dies right after the CAS
that admitted its request, recovered by a second instance with one
fleet's invocations. Each scenario runs through ``repro`` and through
``repro_torch`` (fragments on the CPU); statuses, versions, attempts and
invocation counts must be equal, rows within rtol = atol = 1e-9. Leases
lapse by moving the ``time`` name inside each ``service.ledger``, never by
sleeping."""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.sql.queries import QUERIES

LEASE_S = 30.0


def _pkg(name, **connect_kw):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        name=name, api=mod("api"), svc=mod("service"),
        ledger=mod("service.ledger"), chaos=mod("core.chaos"),
        engine=mod("core.engine"), platform=mod("core.platform"),
        data=mod("data"), physical=mod("sql.physical"),
        storage=mod("storage"), kw=connect_kw)


REF = _pkg("repro")
PORT = _pkg("repro_torch", device="cpu")
PKGS = (REF, PORT)


class _Clock:
    """The ``time`` module inside a ledger module: the wall clock plus an
    offset that the test moves."""

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


def _view(e):
    return (e.status.value, e.version, e.owner, e.attempt)


def _config(pkg):
    # calibration off: no cross-run state, so invocation counts and plans
    # are the same in a reference run and a chaos run
    return pkg.engine.CoordinatorConfig(
        planner=pkg.physical.PlannerConfig(
            bytes_per_worker=250_000, broadcast_threshold_bytes=150_000,
            exchange_partitions=3),
        calibrate_selectivity=False)


def _fresh_db(pkg):
    store = pkg.storage.ObjectStore(tier="local", seed=0)
    return store, pkg.data.generate_tpch(store, sf=0.01, n_parts=4, seed=0)


def _both(scenario):
    ref, port = (scenario(pkg) for pkg in PKGS)
    ref_rows, port_rows = ref.pop("rows", None), port.pop("rows", None)
    assert port == ref
    if ref_rows is not None:
        for k in ref_rows:
            np.testing.assert_allclose(
                np.sort(np.asarray(port_rows[k], np.float64)),
                np.sort(np.asarray(ref_rows[k], np.float64)),
                rtol=1e-9, atol=1e-9, err_msg=k)
    return ref


@pytest.mark.parametrize("die_at", ["ADMITTED", "RUNNING"])
def test_ledger_kill_after_cas_is_recoverable(die_at, clock):
    """The instance dies right after the CAS that landed ``die_at``: the
    record is consistent, its owner gone, and once the lease lapses
    recovery hands it back to QUEUED for a peer."""
    def scenario(pkg):
        RS = pkg.svc.RequestStatus
        store = pkg.storage.ObjectStore(tier="local", seed=0)
        store.chaos = pkg.chaos.ChaosEngine(pkg.chaos.ChaosConfig(
            kill_points=(f"ledger.{die_at}",)))
        led = pkg.svc.RequestLedger(store, lease_ttl_s=0.05)
        led.submit("q", request_id="r")
        if die_at == "ADMITTED":
            with pytest.raises(pkg.chaos.ChaosKill):
                led.claim("r", "svc-dead")
        else:
            led.claim("r", "svc-dead")
            with pytest.raises(pkg.chaos.ChaosKill):
                led.transition("r", RS.RUNNING, if_owner="svc-dead")
        dead = _view(led.get("r"))
        clock.advance(0.1)
        recovered = [e.request_id for e in led.recover_expired()]
        after = _view(led.get("r"))
        peer = led.claim("r", "svc-peer") is not None
        return {"dead": dead, "recovered": recovered, "after": after,
                "peer": peer,
                "fired": store.chaos.injected.get(f"kill:ledger.{die_at}")}
    ref = _both(scenario)
    v = 2 if die_at == "ADMITTED" else 3
    assert ref == {"dead": (die_at, v, "svc-dead", 0), "recovered": ["r"],
                   "after": ("QUEUED", v + 1, None, 1), "peer": True,
                   "fired": 1}


def test_ledger_kill_after_terminal_cas_keeps_result(clock):
    """Death right after the SUCCEEDED CAS: the terminal record and its
    result pointer survive, and recovery has nothing to do."""
    def scenario(pkg):
        RS = pkg.svc.RequestStatus
        store = pkg.storage.ObjectStore(tier="local", seed=0)
        store.chaos = pkg.chaos.ChaosEngine(pkg.chaos.ChaosConfig(
            kill_points=("ledger.SUCCEEDED",)))
        led = pkg.svc.RequestLedger(store, lease_ttl_s=0.05)
        led.submit("q", request_id="r")
        led.claim("r", "svc")
        led.transition("r", RS.RUNNING, if_owner="svc")
        with pytest.raises(pkg.chaos.ChaosKill):
            led.transition("r", RS.SUCCEEDED, if_owner="svc",
                           result={"prefix": "results/h"})
        clock.advance(0.1)
        e = led.get("r")
        return {"recovered": led.recover_expired(), "entry": _view(e),
                "result": e.result}
    ref = _both(scenario)
    assert ref == {"recovered": [], "entry": ("SUCCEEDED", 4, None, 0),
                   "result": {"prefix": "results/h"}}


def test_late_lease_renewal_is_fenced(clock):
    """Once the lease deadline passed, the slow owner's renewal fails
    whether it comes before or after recovery re-queues the entry."""
    def scenario(pkg):
        store = pkg.storage.ObjectStore(tier="local", seed=0)
        led = pkg.svc.RequestLedger(store, lease_ttl_s=0.05)
        led.submit("q", request_id="r")
        led.claim("r", "svc-slow")
        clock.advance(0.1)
        early = led.renew_lease("r", "svc-slow")
        not_extended = led.get("r").lease_expires < clock.time()
        recovered = [e.request_id for e in led.recover_expired()]
        owner = led.get("r").owner
        late = led.renew_lease("r", "svc-slow")
        return {"early": early, "not_extended": not_extended,
                "recovered": recovered, "owner": owner, "late": late,
                "entry": _view(led.get("r"))}
    ref = _both(scenario)
    assert ref == {"early": False, "not_extended": True,
                   "recovered": ["r"], "owner": None, "late": False,
                   "entry": ("QUEUED", 3, None, 1)}


def test_service_dispatcher_death_recovered_by_second_instance(clock):
    """The dispatcher dies by a chaos kill right after the ledger CAS
    that admitted its request, before any worker ran; once the lease
    lapses a second instance over the same ledger re-queues and finishes
    the query with one fleet's invocations on the shared platform."""
    def scenario(pkg):
        store0, catalog0 = _fresh_db(pkg)
        p0 = pkg.platform.FaasPlatform(quota=16, seed=0)
        with pkg.api.connect(store0, catalog0, platform=p0,
                             config=_config(pkg), max_concurrent_queries=4,
                             **pkg.kw) as s0:
            s0.sql(QUERIES["q6"])
        solo = p0.invocations
        p0.close()

        store, catalog = _fresh_db(pkg)
        chaos = pkg.chaos.ChaosEngine(pkg.chaos.ChaosConfig(
            kill_points=("ledger.ADMITTED",)))
        store.chaos = chaos          # before the ledger takes its view
        ledger = pkg.svc.RequestLedger(store, lease_ttl_s=LEASE_S)
        platform = pkg.platform.FaasPlatform(quota=16, seed=0)
        s1 = pkg.api.connect(store, catalog, platform=platform,
                             config=_config(pkg), max_concurrent_queries=4,
                             **pkg.kw)
        svc1 = pkg.svc.QueryService(s1, ledger=ledger)
        s2 = svc2 = None
        try:
            h = svc1.submit(QUERIES["q6"])
            deadline = time.monotonic() + 30
            while not svc1._closing.is_set() \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            died = svc1._closing.is_set()
            e = ledger.get(h.request_id)
            admitted = (e.status.value, e.version,
                        e.owner == svc1.service_id, e.attempt)
            before = platform.invocations
            svc1.kill()
            clock.advance(LEASE_S + 1)              # the lease lapses
            s2 = pkg.api.connect(store, catalog, platform=platform,
                                 config=_config(pkg),
                                 max_concurrent_queries=4, **pkg.kw)
            svc2 = pkg.svc.QueryService(s2, ledger=ledger)
            handle = pkg.svc.ServiceHandle(h.request_id, svc2)
            entry = handle.wait(timeout=120)
            cols = handle.fetch(timeout=30)
            return {"died": died, "fired": chaos.injected.get(
                        "kill:ledger.ADMITTED"),
                    "admitted": admitted, "before": before,
                    "entry": (entry.status.value, entry.owner,
                              entry.attempt),
                    "solo": solo, "invocations": platform.invocations,
                    "n": len(cols["revenue"]), "rows": cols}
        finally:
            if svc2 is not None:
                svc2.close()
                s2.close()
            s1.close()
            platform.close()
    ref = _both(scenario)
    assert ref["died"] and ref["fired"] == 1
    assert ref["admitted"] == ("ADMITTED", 2, True, 0)   # the CAS landed
    assert ref["before"] == 0                      # ... before any worker
    assert ref["entry"] == ("SUCCEEDED", None, 1)  # recovery recorded
    assert ref["invocations"] == ref["solo"] > 0   # exactly one fleet
    assert ref["n"] == 1
