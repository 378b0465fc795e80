"""Where the card's idle time goes, by the program's spans: one run of a
benchmark cell with the program's tracing on.

    python3 probes/span_gaps.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 1 [--device cpu --sf 0.01]

Runs ``skybench.run`` in this process, its arguments as given, with a
span recorder (``skybench.spans.make_span_recorder``) added to the
cell's session right before the window opens, after the validation
warm-up; the harness itself adds none, so its own runs keep tracing
off. After the harness's lines and its result line it prints:

- the spans a query answered in the window sent, by name;
- the ten longest idle gaps of the card (``DeviceTrace.gaps``) with the
  leaf spans open at each gap's host-time midpoint (query kind, span,
  pipeline id);
- each leaf span name's share of the window's idle time, and the share
  no leaf span explains;
- the clock check: the share of the host-to-device copies' device time
  that lies inside ``fragment.upload`` spans, mapped through
  ``DeviceTrace.host_time``;
- the span readers' values (``skybench/metrics/``: the planner, the
  exchange waits, the workers' reads, writes and uploaded bytes, the
  unexplained idle share);
- the host cost of one span, timed in this process before the run;

and, last, one JSON object of all of it. Off the card (``--device cpu``)
the gap lines are left out.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from skybench import run as harness, spans  # noqa: E402

READERS = ("planner.plan_ms_per_query", "exchange.wait_ms_per_query",
           "worker.read_ms_per_query", "worker.write_ms_per_query",
           "worker.upload_bytes_per_query", "device.idle_unexplained_share")


def span_cost_ns(n: int = 200_000) -> dict:
    """Host ns of one span: a coordinator-side span sent to a recorder
    through a session's mux, and a worker-side one logged and relayed."""
    from repro_torch.core.events import ObserverMux, Span, emit_span
    from repro_torch.exec.fragment import SpanLog
    mux = ObserverMux([spans.make_span_recorder()])
    t = time.perf_counter_ns()
    for _ in range(n):
        t0 = time.perf_counter_ns()
        emit_span(mux, "q", "engine.wait", t0, 1, what="gate")
    emit = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n // 100):
        log = SpanLog()
        for _ in range(100):
            log.begin("fragment.read")
            log.end(bytes=1)
        for row in log.rows:
            mux.on_span(Span(1, 2, "q", row[0], row[1], row[2], log.thread,
                             dict(row[4], pid=0, fragment=0, attempt=0)))
    worker = (time.perf_counter_ns() - t) / n
    return {"coordinator_span_ns": emit, "worker_span_ns": worker}


def main(argv: list[str]) -> int:
    cost = span_cost_ns()
    recorder = spans.make_span_recorder()
    box: dict = {}
    make_recorder, counters = harness.probe.make_recorder, \
        harness.probe.counters
    read_metric = harness._metric_reader

    def make():
        rec = make_recorder()
        wrap = rec.wrap_submit

        def wrap_submit(session):
            box["session"] = session
            wrap(session)
        rec.wrap_submit = wrap_submit
        return rec

    def counted():
        # the first count after the cell's client exists is the window's
        # open: the validation warm-up is over
        if "session" in box and "added" not in box:
            box["session"].add_observer(recorder)
            box["added"] = True
        return counters()

    def reader(name):
        read = read_metric(name)

        def capture(run):
            box["run"] = run
            return read(run)
        return capture

    harness.probe.make_recorder = make
    harness.probe.counters = counted
    harness._metric_reader = reader
    rc = harness.main(argv)
    run = box.get("run")
    if rc != 0 or run is None:
        return rc or 1
    run.spans = recorder.spans
    out = {"spans_sent": len(recorder.spans),
           "spans_a_query": spans.by_name_per_query(run),
           "span_cost": cost,
           "metrics": {n: read_metric(n)(run) for n in READERS}}
    gaps = spans.idle_gaps(run)
    if gaps is not None:
        out["gaps"] = [[b - a, spans.open_at(run, (a + b) / 2)]
                       for a, b in gaps[:10]]
        out["idle_share_by_name"] = {
            str(k): v for k, v in spans.idle_share_by_name(run).items()}
        out["copies_inside_upload_pct"] = spans.copies_inside(run)
    print(f"[span_gaps] spans a query by name: "
          f"{json.dumps(out['spans_a_query'])}", flush=True)
    for length, open_ in out.get("gaps", []):
        print(f"[span_gaps] gap {length:.6f} s: "
              + ("; ".join(f"{q} {n} p{pid}" for q, n, pid in open_)
                 or "no span open"), flush=True)
    print(f"[span_gaps] share of the idle time by span: "
          f"{json.dumps(out.get('idle_share_by_name'))}; clock check "
          f"{out.get('copies_inside_upload_pct')} % of the copies inside "
          f"fragment.upload", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
