"""Spans of the port's query path (``repro_torch.core.events``): Q3 and Q6
at SF 0.01 through a session on the CPU, traced by an observer that
overrides ``on_span``, and the same queries with only a plain observer.

A traced query is one tree: a ``query`` root, its plan, its pipelines,
their waits and fragments, and each fragment's phases as its worker
recorded them, every child inside its parent's interval on the host's
``perf_counter_ns`` clock. Untraced, no span site reads the clock, no
fragment spec carries the trace mark and no worker records a span; and
tracing changes no answer and no count.
"""

import math
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest

from repro_torch.api import connect
from repro_torch.core import CoordinatorConfig
from repro_torch.core import worker as worker_mod
from repro_torch.core.events import (ObserverMux, QueryObserver,
                                     wants_spans)
from repro_torch.exec import fragment as fragment_mod
from repro_torch.exec.batch import bucket_capacity
from repro_torch.exec.fragment import SpanLog
from repro_torch.data import generate_tpch
from repro_torch.kernels import ext
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.storage import ObjectStore

PLANNER = PlannerConfig(bytes_per_worker=500_000,
                        broadcast_threshold_bytes=250_000,
                        exchange_partitions=4)
QUERY_NAMES = ("q3", "q6")
# every fragment that runs a device program records these phases
PHASES = {"fragment.read", "fragment.upload", "fragment.compute",
          "fragment.download", "fragment.write"}


class SpanRecorder(QueryObserver):
    def __init__(self):
        self.spans = []

    def on_span(self, span):
        self.spans.append(span)


class Fragments:
    """Each worker call's spec and its result's spans."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = worker_mod.execute_fragment

        def execute(store, spec, **kw):
            res = inner(store, spec, **kw)
            self.calls.append((spec, res.stats.spans))
            return res
        monkeypatch.setattr(worker_mod, "execute_fragment", execute)


def _run(observer, *, pipelined=True, device="cpu"):
    """Q3 and Q6 on fresh SF 0.01 tables: each query's rows, pipeline
    counts and launch counts."""
    store = ObjectStore(tier="local", seed=0)
    catalog = generate_tpch(store, sf=0.01, n_parts=4, seed=0)
    cfg = CoordinatorConfig(planner=PLANNER, use_result_cache=False,
                            pipelined=pipelined)
    out = {}
    with connect(store, catalog, device=device, config=cfg,
                 observers=(observer,)) as session:
        for q in QUERY_NAMES:
            before = ext.launches()
            res = session.sql(QUERIES[q])
            after = ext.launches()
            out[q] = {
                "rows": res.fetch(store),
                "reports": [(p.pid, p.bytes_read, p.n_fragments,
                             p.kernel_fragments)
                            for p in res.stats.pipelines],
                "launches": {k: v - before.get(k, 0)
                             for k, v in after.items()},
            }
    return out


@pytest.fixture(scope="module")
def traced():
    mp = pytest.MonkeyPatch()
    try:
        frags = Fragments(mp)
        rec = SpanRecorder()
        t0 = time.perf_counter_ns()
        _run(rec)
        t1 = time.perf_counter_ns()
    finally:
        mp.undo()
    return {"spans": rec.spans, "t0": t0, "t1": t1,
            "fragments": frags.calls}


def test_every_query_has_one_root_and_every_chain_reaches_it(traced):
    spans = traced["spans"]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    assert all(s.name == "query" for s in roots)
    assert Counter(s.query_id for s in roots) == Counter(
        {q: 1 for q in {s.query_id for s in spans}})
    assert len(roots) == len(QUERY_NAMES)
    for s in spans:
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
            assert top.query_id == s.query_id
        assert top.name == "query"
    names = Counter(s.name for s in spans)
    assert names["query.plan"] == len(QUERY_NAMES)
    assert names["pipeline"] >= len(QUERY_NAMES)
    assert names["engine.wait"] > 0     # Q3's consumers wait in pipelined mode


def test_every_child_lies_within_its_parent(traced):
    by_id = {s.id: s for s in traced["spans"]}
    for s in traced["spans"]:
        assert s.t0_ns <= s.t1_ns, s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)


def test_every_fragment_records_its_phases(traced):
    spans = traced["spans"]
    children: dict[int, set] = {}
    for s in spans:
        children.setdefault(s.parent, set()).add(s.name)
    frags = [s for s in spans if s.name == "fragment"]
    assert frags
    for f in frags:
        got = children.get(f.id, set())
        assert PHASES <= got or got == {"fragment.merge"}, (f, got)
        assert {"pid", "fragment", "attempt"} <= set(f.attrs)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("fragment."):
            f = by_id[s.parent]
            while f.name != "fragment":
                f = by_id[f.parent]
            assert {k: s.attrs[k] for k in f.attrs} == f.attrs
    uploads = [s for s in spans if s.name == "fragment.upload"]
    reads = [s for s in spans if s.name == "fragment.read"]
    # the copies hold every column at its bucketed capacity (floor 1024
    # rows) plus its mask: never fewer bytes than a row count gives
    assert all(s.attrs["bytes"] >= 1024 for s in uploads)
    assert sum(s.attrs["bytes"] for s in reads) > 0
    assert all(s.attrs["rows"] >= 0 for s in reads + uploads)


def test_spans_lie_inside_the_calls_clock_interval(traced):
    for s in traced["spans"]:
        assert traced["t0"] <= s.t0_ns <= s.t1_ns <= traced["t1"], s


def test_a_traced_fragment_carries_the_mark_and_its_spans(traced):
    calls = traced["fragments"]
    assert calls
    for spec, spans in calls:
        assert spec.get("trace") is True
        assert isinstance(spans, SpanLog) and spans.rows
        assert all(r[2] >= r[1] for r in spans.rows)


def test_untraced_run_reads_no_span_clock_and_records_nothing(monkeypatch):
    frags = Fragments(monkeypatch)
    reads = []
    clock = time.perf_counter_ns

    def counted():
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if caller.startswith("repro_torch"):
            reads.append(caller)
        return clock()
    monkeypatch.setattr(time, "perf_counter_ns", counted)
    plain = QueryObserver()
    _run(plain)
    assert frags.calls
    assert all("trace" not in spec for spec, _ in frags.calls)
    assert all(spans is None for _, spans in frags.calls)
    assert reads == []


@pytest.mark.parametrize("q", QUERY_NAMES)
def test_tracing_changes_no_answer_and_no_count(q):
    """Barrier mode, where a run's fleet sizes and bytes read repeat
    exactly (pipelined mode's top-up batches follow the threads'
    timing)."""
    on = _run(SpanRecorder(), pipelined=False)[q]
    off = _run(QueryObserver(), pipelined=False)[q]
    assert on["reports"] == off["reports"]
    assert on["launches"] == off["launches"]
    assert sorted(on["rows"]) == sorted(off["rows"])
    for c in on["rows"]:
        np.testing.assert_array_equal(on["rows"][c], off["rows"][c])


def test_the_mux_traces_only_for_an_observer_that_takes_spans():
    class Loud(QueryObserver):
        def on_span(self, span):
            raise RuntimeError("an observer's fault never fails a query")

    mux = ObserverMux([QueryObserver()])
    assert not mux.wants_spans and not wants_spans(mux)
    assert not wants_spans(QueryObserver())
    outer = ObserverMux([mux])
    assert not outer.wants_spans
    rec = SpanRecorder()
    mux.add(Loud())
    mux.add(rec)
    assert mux.wants_spans and wants_spans(mux) and wants_spans(rec)
    assert ObserverMux([mux]).wants_spans
    mux.on_span("a span")
    assert rec.spans == ["a span"]


def test_span_log_nests_as_the_calls_do():
    log = SpanLog()
    log.begin("fragment.read")
    log.begin("fragment.wait")
    log.end()
    log.end(bytes=3)
    log.begin("fragment.upload", rows=1)
    log.end(bytes=8)
    names = [(r[0], r[3], r[4]) for r in log.rows]
    assert names == [("fragment.read", None, {"bytes": 3}),
                     ("fragment.wait", 0, {}),
                     ("fragment.upload", None, {"rows": 1, "bytes": 8})]
    r0, r1 = log.rows[0], log.rows[1]
    assert r0[1] <= r1[1] <= r1[2] <= r0[2]


class Uploads:
    """Each worker call's ``fragment.upload`` attrs, beside the bytes its
    blocks hold by their numpy inputs: every column at its bucketed
    capacity and one mask byte a row of it."""

    def __init__(self, monkeypatch):
        self.calls = []
        local = threading.local()
        inner_exec = worker_mod.execute_fragment
        inner_from = fragment_mod.from_numpy

        def from_numpy(cols, capacity, device):
            cap = bucket_capacity(
                len(next(iter(cols.values()))) if cols else 0)
            local.bytes += cap + sum(
                cap * a.dtype.itemsize * math.prod(a.shape[1:])
                for a in cols.values())
            return inner_from(cols, capacity, device)

        def execute(store, spec, **kw):
            local.bytes = 0
            res = inner_exec(store, spec, **kw)
            rows = [r for r in res.stats.spans.rows
                    if r[0] == "fragment.upload"]
            self.calls.append((spec, local.bytes, [r[4] for r in rows]))
            return res
        monkeypatch.setattr(fragment_mod, "from_numpy", from_numpy)
        monkeypatch.setattr(worker_mod, "execute_fragment", execute)


def test_upload_counts_its_bytes_as_before_and_stages_nothing_on_the_cpu(
        monkeypatch):
    """``bytes`` is every column at its bucketed capacity plus each
    mask; off the card no byte is copied, staged or not."""
    ups = Uploads(monkeypatch)
    _run(SpanRecorder())
    uploads = [(spec, want, attrs) for spec, want, rows in ups.calls
               for attrs in rows]
    assert uploads
    for spec, want, attrs in uploads:
        assert spec.get("semijoin") is None      # no filter words here
        assert attrs["bytes"] == want >= 1024
        assert attrs["staged"] == 0 and attrs["pageable"] == 0


@pytest.mark.cuda
def test_upload_stages_the_blocks_on_the_card(monkeypatch):
    """On the card every byte of a TPC-H query's blocks is copied from
    pinned staging: ``staged`` and ``pageable`` add up to the bytes
    copied, and ``staged`` is at least 99 % of them."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ups = Uploads(monkeypatch)
    _run(SpanRecorder(), device=None)
    attrs = [a for _, _, rows in ups.calls for a in rows]
    assert attrs
    for a in attrs:
        assert a["staged"] + a["pageable"] == a["bytes"]
    staged = sum(a["staged"] for a in attrs)
    assert staged >= 0.99 * sum(a["bytes"] for a in attrs)
