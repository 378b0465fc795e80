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
- the uploads: the share of the bytes copied to the card that came from
  pinned staging (the ``staged`` and ``pageable`` attributes of
  ``fragment.upload``; absent where the program records neither), and
  the host-to-device throughput, the ``bytes`` of every
  ``fragment.upload`` over the time in which some ``Memcpy HtoD`` ran
  (and over the copies' summed device time), from the window's open
  until the last query sent in it answered; on the card, the pinned
  host allocator's peaks (``torch.cuda.host_memory_stats``);
- what the uploaded bytes hold, from each fragment's ``from_numpy``
  calls in the window: rows, the pad up to the capacity, masks, and the
  bytes an integer column would shed at the narrowest integer type that
  holds its values (their min and max are read on the host, a cost the
  run's other numbers carry);
- the span readers' values (``skybench/metrics/``: the planner, the
  exchange waits, the workers' reads, writes and uploaded bytes, the
  unexplained idle share);
- the host cost of one span, timed in this process before the run;

and, last, one JSON object of all of it. Off the card (``--device cpu``)
the gap lines are left out.
"""

from __future__ import annotations

import bisect
import json
import math
import sys
import threading
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


def uploads(run) -> dict:
    """Staged share of the uploaded bytes and the copies' throughput."""
    ups = [s.attrs for s in run.spans if s.name == "fragment.upload"]
    sent = sum(a.get("bytes", 0) for a in ups)
    out = {"upload_bytes": sent, "staged_share_pct": None}
    if any("staged" in a for a in ups):
        staged = sum(a.get("staged", 0) for a in ups)
        copied = staged + sum(a.get("pageable", 0) for a in ups)
        out.update(staged_bytes=staged, pageable_bytes=copied - staged)
        if copied:
            out["staged_share_pct"] = 100.0 * staged / copied
    if run.trace is None:
        return out
    copies = [(s, t) for n, s, t in run.trace.events if "Memcpy HtoD" in n]
    busy = sum(b - a for a, b in spans.union(copies))
    summed = sum(b - a for a, b in copies)
    out.update(htod_copies=len(copies), htod_busy_s=busy,
               htod_device_s=summed,
               htod_gb_per_s=sent / busy * 1e-9 if busy else None,
               htod_gb_per_s_by_sum=sent / summed * 1e-9 if summed else None)
    out["copies_outside_upload"] = outside(run)
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        out["pinned_host"] = {k: v for k, v in stats().items()
                              if "peak" in k or k.startswith(
                                  ("num_host", "host_alloc_time.total"))}
    return out


def outside(run, name: str = "fragment.upload") -> dict | None:
    """Where the host-to-device copy time that the clock check finds
    outside ``name`` lies: copies that overlap such a span and spill
    past its start (``lead``) or its end (``lag``), by how much at most,
    and copies that overlap none, by activity name."""
    if not getattr(run, "spans", None):
        return None
    tr = run.trace
    merged = spans.host_intervals(s for s in run.spans if s.name == name)
    starts = [a for a, _ in merged]
    lead = lag = 0.0
    lead_max = lag_max = 0.0
    apart: dict = {}
    for n, s, t in tr.events:
        if "Memcpy HtoD" not in n:
            continue
        a, b = tr.host_time(s), tr.host_time(t)
        i = max(bisect.bisect_right(starts, b) - 1, 0)
        over = [(lo, hi) for lo, hi in merged[max(i - 1, 0):i + 2]
                if lo < b and a < hi]
        if not over:
            apart[n] = apart.get(n, 0.0) + (b - a)
            continue
        lo, hi = over[0][0], over[-1][1]
        lead += max(0.0, lo - a)
        lag += max(0.0, b - hi)
        lead_max = max(lead_max, lo - a)
        lag_max = max(lag_max, b - hi)
    return {"lead_s": lead, "lead_max_s": lead_max, "lag_s": lag,
            "lag_max_s": lag_max, "apart_s": apart}


class UploadShapes:
    """Wraps ``exec.fragment``'s ``from_numpy`` once ``start`` is
    called: tallies what each uploaded block holds."""

    def __init__(self):
        self.lock = threading.Lock()
        self.bytes = {"rows": 0, "pad": 0, "masks": 0, "narrower": 0}

    def start(self) -> None:
        from repro_torch.exec import fragment
        inner = fragment.from_numpy

        def from_numpy(cols, capacity, device):
            n = len(next(iter(cols.values()))) if cols else 0
            rows = pad = narrower = 0
            for a in cols.values():
                row = a.dtype.itemsize * math.prod(a.shape[1:])
                rows += n * row
                pad += (capacity - n) * row
                if a.dtype.kind in "iu" and a.size:
                    need = min(w for w in (1, 2, 4, 8)
                               if _fits(a.min(), a.max(), a.dtype.kind, w))
                    narrower += a.size * (a.dtype.itemsize - need)
            with self.lock:
                self.bytes["rows"] += rows
                self.bytes["pad"] += pad
                self.bytes["masks"] += capacity
                self.bytes["narrower"] += narrower
            return inner(cols, capacity, device)
        fragment.from_numpy = from_numpy

    def shares(self) -> dict:
        total = self.bytes["rows"] + self.bytes["pad"] + self.bytes["masks"]
        return {"bytes": dict(self.bytes, total=total),
                "pct_of_total": {k: 100.0 * v / total if total else None
                                 for k, v in self.bytes.items()}}


def _fits(lo, hi, kind: str, width: int) -> bool:
    bits = 8 * width
    if kind == "u":
        return int(hi) < 1 << bits
    return -(1 << bits - 1) <= int(lo) and int(hi) < 1 << bits - 1


def main(argv: list[str]) -> int:
    cost = span_cost_ns()
    recorder = spans.make_span_recorder()
    shapes = UploadShapes()
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
            shapes.start()
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
           "metrics": {n: read_metric(n)(run) for n in READERS},
           "uploads": uploads(run), "upload_shapes": shapes.shares()}
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
    up = out["uploads"]
    print(f"[span_gaps] uploads: {up['upload_bytes']} B, staged share "
          f"{up['staged_share_pct']} %, host-to-device "
          f"{up.get('htod_gb_per_s')} GB/s over the copies' busy time "
          f"({up.get('htod_gb_per_s_by_sum')} GB/s over their summed "
          f"device time); pinned host allocator "
          f"{json.dumps(up.get('pinned_host'))}; what the blocks hold: "
          f"{json.dumps(out['upload_shapes'])}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
