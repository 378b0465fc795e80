"""What the benchmark records of the program while a cell runs.

Spans from the benchmark's side of each call into the program, and the
program's own counters:

- each query the session takes (``SkyriseSession.submit`` wrapped: its
  query id, its text, the time), whoever submits it, the client or the
  service's dispatcher;
- each pipeline report (``QueryObserver.on_pipeline_complete``: bytes
  read, the fused kernel and how many fragments ran it, cache hits,
  shared runs) and each query's lifecycle (``on_query_state``), with the
  time each came;
- the kernel launches the program counts (``kernels.ext.launches``) and
  the scan kernels it has loaded (``kernels.specialise.loaded``), read
  when the window opens and when it closes.
"""

from __future__ import annotations

import threading
import time


def make_recorder():
    """A fresh recorder; a subclass of the program's observer."""
    from repro_torch.core.events import QueryObserver

    class Recorder(QueryObserver):
        def __init__(self):
            self.lock = threading.Lock()
            self.text_of: dict[str, str] = {}      # query id → text
            self.qid_of: dict[str, str] = {}       # text → last query id
            self.pipelines: dict[str, list] = {}   # query id → [(t, report)]
            self.states: dict[str, list] = {}      # query id → [(t, state)]
            self.stragglers = 0

        def wrap_submit(self, session) -> None:
            inner = session.submit

            def submit(sql, *a, **kw):
                handle = inner(sql, *a, **kw)
                with self.lock:
                    self.text_of[handle.query_id] = sql
                    self.qid_of[sql] = handle.query_id
                return handle
            session.submit = submit

        def on_query_state(self, query_id, state):
            with self.lock:
                self.states.setdefault(query_id, []).append(
                    (time.perf_counter(), state))

        def on_pipeline_complete(self, query_id, report):
            with self.lock:
                self.pipelines.setdefault(query_id, []).append(
                    (time.perf_counter(), report))

        def on_straggler(self, query_id, pid, fragment):
            with self.lock:
                self.stragglers += 1

        def reports(self, text: str) -> list:
            """The pipeline reports of the last query sent as ``text``."""
            with self.lock:
                qid = self.qid_of.get(text)
                return [r for _, r in self.pipelines.get(qid, [])]

    return Recorder()


def counters() -> dict:
    """The program's launch counts and its loaded scan kernels, now."""
    from repro_torch.kernels import ext, specialise
    return {"launches": ext.launches(),
            "loaded": [(k.origin, k.compile_ms, k.kind)
                       for k in specialise.loaded()]}
