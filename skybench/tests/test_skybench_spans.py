"""The span readers (``skybench/spans.py`` and the metrics that read the
program's spans) on synthetic spans and a device trace built by hand:
a query answered in the window beside one that was not, a read whose
partial-manifest wait must not count as reading, copies inside an
upload, and idle gaps of the card that spans cover, in part or not at
all."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core.events import Span  # noqa: E402
from skybench import run as harness, spans  # noqa: E402
from skybench.trace import DeviceTrace  # noqa: E402

NEW = ("planner.plan_ms_per_query", "exchange.wait_ms_per_query",
       "worker.read_ms_per_query", "worker.write_ms_per_query",
       "worker.upload_bytes_per_query", "device.idle_unexplained_share")
HOST_T0, DEV_T0 = 100.0, 5.0     # the marker fill: host = device + 95 s


def _ns(t: float) -> int:
    return round(t * 1e9)


class _Spans:
    def __init__(self):
        self.all = []

    def add(self, qid, name, t0, t1, parent=None, **attrs):
        s = Span(len(self.all) + 1, parent, qid, name, _ns(t0), _ns(t1),
                 "t", attrs)
        self.all.append(s)
        return s.id


def _trace():
    """The window [100, 101] s on the host; the card busy with a copy at
    device 5.46–5.49 s and kernels at 5.50–5.60 and 5.75–5.80 s, idle in
    gaps 5.0–5.46, 5.49–5.50, 5.60–5.75 and 5.80–6.0 s (0.82 s)."""
    tr = DeviceTrace(None, None)
    tr.host_t0, tr.dev_t0 = HOST_T0, DEV_T0
    tr.window_s = tr.span_s = 1.0
    tr.events = [("Memcpy HtoD (Pageable -> Device)", 5.46, 5.49),
                 ("kernel_a", 5.50, 5.60), ("kernel_b", 5.75, 5.80)]
    return tr


def _spans():
    sp = _Spans()
    q = sp.add("qA", "query", 99.95, 101.0)
    sp.add("qA", "query.plan", 99.95, 100.0, q)                   # 50 ms
    p = sp.add("qA", "pipeline", 100.0, 101.0, q, pid=1)
    sp.add("qA", "engine.wait", 100.0, 100.05, p, pid=1, what="gate")
    f = sp.add("qA", "fragment", 100.05, 100.9, p, pid=1)
    r = sp.add("qA", "fragment.read", 100.05, 100.45, f, bytes=10)
    sp.add("qA", "fragment.wait", 100.25, 100.35, r)               # 100 ms
    sp.add("qA", "fragment.upload", 100.45, 100.58, f, bytes=4096)
    sp.add("qA", "fragment.compute", 100.58, 100.62, f)
    sp.add("qA", "fragment.download", 100.62, 100.63, f)
    sp.add("qA", "fragment.write", 100.63, 100.70, f)              # 70 ms
    # a query the window did not answer: it explains idle time, and
    # counts in no query's figures
    qb = sp.add("qB", "query", 100.85, 101.2)
    sp.add("qB", "fragment.write", 100.9, 100.95, qb)
    sp.add("qB", "fragment.upload", 100.96, 100.97, qb, bytes=1 << 20)
    return sp.all


class _Recorder:
    text_of = {"qA": "A", "qB": "B"}


def _run(spans_=None, trace=None):
    done = [{"text": "A", "start": 99.9, "end": 101.1, "q": "q3"}]
    return harness.Run(
        records=done + [{"text": "B", "start": 100.8, "end": 101.3}],
        done=done, recorder=_Recorder(), trace=trace,
        kind_of_text={"A": "q3", "B": "q12"},
        spans=_spans() if spans_ is None else spans_)


def _read(name, run):
    return harness._metric_reader(name)(run)


def test_each_reader_on_synthetic_spans():
    run = _run(trace=_trace())
    got = {name: _read(name, run) for name in NEW}
    assert got["planner.plan_ms_per_query"] == pytest.approx(50.0)
    assert got["exchange.wait_ms_per_query"] == pytest.approx(150.0)
    # 400 ms of read less its 100 ms wait on the partial manifest
    assert got["worker.read_ms_per_query"] == pytest.approx(300.0)
    assert got["worker.write_ms_per_query"] == pytest.approx(70.0)
    assert got["worker.upload_bytes_per_query"] == 4096
    # idle 0.82 s; open leaf spans cover all of it but 100.70–100.75 s
    # (no span at all), 100.80–100.90 and 100.95–100.96 s (qB's write
    # covers 100.90–100.95, its upload 100.96–100.97) and 100.97–101.0
    assert got["device.idle_unexplained_share"] == pytest.approx(
        100.0 * 0.19 / 0.82)


def test_the_share_by_name_and_what_each_gap_holds():
    run = _run(trace=_trace())
    by = spans.idle_share_by_name(run)
    assert by["fragment.read"] == pytest.approx(100.0 * 0.40 / 0.82)
    assert by["fragment.wait"] == pytest.approx(100.0 * 0.10 / 0.82)
    assert by[None] == pytest.approx(100.0 * 0.19 / 0.82)
    assert "fragment" not in by and "pipeline" not in by
    a, b = spans.idle_gaps(run)[0]          # the longest: 100.0–100.46
    assert (a, b) == (pytest.approx(100.0), pytest.approx(100.46))
    assert spans.open_at(run, 100.3) == [("q3", "fragment.read", -1),
                                         ("q3", "fragment.wait", -1)]
    assert spans.open_at(run, 100.72) == []
    assert spans.open_at(run, 100.92) == [("q12", "fragment.write", -1)]


def test_the_copies_lie_inside_the_upload():
    assert spans.copies_inside(_run(trace=_trace())) == pytest.approx(100.0)
    late = _trace()
    late.events[0] = ("Memcpy HtoD (Pageable -> Device)", 5.56, 5.60)
    assert spans.copies_inside(_run(trace=late)) == pytest.approx(50.0)


def test_spans_of_each_name_a_query_sent():
    assert spans.by_name_per_query(_run()) == {
        "engine.wait": 1, "fragment": 1, "fragment.compute": 1,
        "fragment.download": 1, "fragment.read": 1, "fragment.upload": 1,
        "fragment.wait": 1, "fragment.write": 1, "pipeline": 1,
        "query": 1, "query.plan": 1}


def test_without_spans_or_off_the_card_a_reader_returns_none():
    for name in NEW:
        assert _read(name, _run(spans_=[], trace=_trace())) is None, name
    host = _run()
    for name in NEW[:-1]:
        assert _read(name, host) is not None, name
    assert _read("device.idle_unexplained_share", host) is None
    assert spans.copies_inside(host) is None


def test_intervals():
    merged = spans.union([(3, 4), (0, 1), (0.5, 2), (4, 5)])
    assert merged == [(0, 2), (3, 5)]
    assert spans.covered(1, 4, merged) == 2
    assert spans.covered(5, 9, merged) == 0
    assert spans.covered(-1, 0.25, merged) == 0.25
