"""The program's spans, for the per-layer readers that take them.

``make_span_recorder()`` gives a ``QueryObserver`` of the port that
overrides ``on_span``: added to a session (``session.add_observer``), it
turns the program's tracing on and keeps every span in memory
(``repro_torch.core.events.Span``: its id and its parent's, the query,
the name, ``t0_ns`` and ``t1_ns`` on the host's ``perf_counter_ns``
clock, the thread, ``attrs``). A run hands its spans to the readers as
``run.spans``; where it has none (a program that sends no spans, or a
run that added no recorder) every reader returns None.

``perf_counter_ns`` is the clock ``time.perf_counter`` reads, so a span
lies on the timeline of ``skybench.trace.DeviceTrace.host_time`` as
recorded: device activities and host spans compare with no further
work.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

# spans that enclose others; every other span is a leaf of the code the
# host was in (a phase of a fragment, a wait, the planner)
OUTER = ("query", "pipeline", "fragment")
NS = 1e-9


def make_span_recorder():
    """A fresh recorder: a subclass of the program's observer."""
    from repro_torch.core.events import QueryObserver

    class SpanRecorder(QueryObserver):
        def __init__(self):
            self.spans: list = []

        def on_span(self, span):
            self.spans.append(span)   # one append: atomic under the GIL

    return SpanRecorder()


def of_done(run) -> list | None:
    """The spans of the queries answered in the window (each answered
    query's own run: its ``query`` span began while its client waited
    for it), or None where the run has no spans."""
    spans = getattr(run, "spans", None)
    if not spans or not run.done:
        return None
    starts = {s.query_id: s.t0_ns * NS for s in spans if s.name == "query"}
    qids_of = defaultdict(list)
    for qid, text in run.recorder.text_of.items():
        qids_of[text].append(qid)
    done = {qid for r in run.done for qid in qids_of.get(r["text"], ())
            if r["start"] <= starts.get(qid, -1.0) <= r["end"]}
    return [s for s in spans if s.query_id in done]


def self_ns(span, children: list) -> int:
    """``span``'s time less the part its children cover."""
    merged = union((c.t0_ns, c.t1_ns) for c in children)
    return (span.t1_ns - span.t0_ns) - int(
        covered(span.t0_ns, span.t1_ns, merged))


def ms_per_query(run, names, self_time: bool = False) -> float | None:
    """Milliseconds of the spans called ``names`` (or of their self time)
    over the queries answered in the window."""
    spans = of_done(run)
    if spans is None:
        return None
    kids = defaultdict(list)
    if self_time:
        for s in spans:
            kids[s.parent].append(s)
    ns = sum(self_ns(s, kids[s.id]) if self_time else s.t1_ns - s.t0_ns
             for s in spans if s.name in names)
    return ns * 1e-6 / len(run.done)


def attr_per_query(run, name: str, key: str) -> float | None:
    """``attrs[key]`` of the spans called ``name``, summed over the
    queries answered in the window."""
    spans = of_done(run)
    if spans is None:
        return None
    return sum(s.attrs.get(key, 0) for s in spans
               if s.name == name) / len(run.done)


def by_name_per_query(run) -> dict | None:
    """How many spans of each name a query answered in the window sent."""
    spans = of_done(run)
    if spans is None:
        return None
    return {n: c / len(run.done)
            for n, c in sorted(Counter(s.name for s in spans).items())}


# -- intervals -------------------------------------------------------------------

def union(intervals) -> list[tuple]:
    """Sorted, disjoint intervals covering the same points."""
    out: list[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(a, b, merged: list[tuple]) -> float:
    """The length of ``[a, b]`` that ``merged`` (from ``union``) covers."""
    i = max(bisect.bisect_right(merged, (a,)) - 1, 0)
    total = 0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(a, merged[i][0]), min(b, merged[i][1])
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def leaves(spans) -> list:
    return [s for s in spans if s.name not in OUTER]


def host_intervals(spans) -> list[tuple]:
    """The spans' union, in host seconds."""
    return union((s.t0_ns * NS, s.t1_ns * NS) for s in spans)


# -- the card's idle gaps against the host's spans -------------------------------

def idle_gaps(run) -> list[tuple] | None:
    """The window's idle gaps of the card (``DeviceTrace.gaps``, longest
    first) in host seconds, or None off the card or without spans."""
    if run.trace is None or not getattr(run, "spans", None):
        return None
    tr = run.trace
    return [(tr.host_time(a), tr.host_time(b)) for a, b in tr.gaps()]


def idle_share_by_name(run) -> dict | None:
    """Per leaf span name, the share (%) of the window's idle time in
    which a span of that name, of any query, was open; ``None`` under
    the name of the share in which no leaf span was. Names overlap, so
    the shares add up to more than 100."""
    gaps = idle_gaps(run)
    if gaps is None:
        return None
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    by = defaultdict(list)
    for s in leaves(run.spans):
        by[s.name].append(s)
    out = {}
    for name, spans in sorted(by.items()):
        merged = host_intervals(spans)
        out[name] = 100.0 * sum(covered(a, b, merged)
                                for a, b in gaps) / total
    merged = host_intervals(leaves(run.spans))
    out[None] = 100.0 * sum((b - a) - covered(a, b, merged)
                            for a, b in gaps) / total
    return out


def open_at(run, t: float) -> list[tuple]:
    """The leaf spans open at host time ``t``: (query kind, name, pid)."""
    ns = t / NS
    return sorted({(run.kind_of_qid(s.query_id) or "?", s.name,
                    s.attrs.get("pid", -1))
                   for s in leaves(run.spans) if s.t0_ns <= ns <= s.t1_ns})


def copies_inside(run, name: str = "fragment.upload") -> float | None:
    """The share (%) of the traced span's host-to-device copy time (the
    profiler's ``Memcpy HtoD`` activities) that lies inside some
    span called ``name`` once mapped through ``host_time``: how well the
    two clocks agree."""
    if run.trace is None or not getattr(run, "spans", None):
        return None
    tr = run.trace
    copies = [(tr.host_time(s), tr.host_time(t))
              for n, s, t in tr.events if "Memcpy HtoD" in n]
    total = sum(b - a for a, b in copies)
    if total <= 0:
        return None
    merged = host_intervals(s for s in run.spans if s.name == name)
    return 100.0 * sum(covered(a, b, merged) for a, b in copies) / total
