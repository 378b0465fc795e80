"""Run one cell of the benchmark once and print its result line.

    python3 -m skybench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``)
and ``BENCHMARK.json``. The cell names a configuration
(``skybench/configs/<name>.json``: the data, the client and its
settings, the guarantee) and a traffic mix (``skybench/traffic/<name>.json``);
each metric is read by ``skybench/metrics/<name>.py``.

A run: the tables are made from the seed and loaded through the port's
SPAX writer; the kernels every query of the mix can need are built or
loaded, the queries' validation texts warm the cell; then the mix's
clients send their queries, each waiting for its answer, for
``--seconds``. Every answer is then held against the plain numpy
reference (``skybench.reference``). On the card every run profiles it
from the window's open until the last query sent in the window has
answered (the card time a query costs is an end-to-end metric);
``--trace 1`` reports the per-layer metrics instead of the end-to-end
ones, and records the program's spans (``skybench.spans``) from the
window's open for the readers that take them; ``--trace 0`` adds no span
recorder, so the program's span sites read no clock.

``--device cpu --sf 0.01`` rehearses a run on the CPU with the port's
plain kernels: its device fields say so and no device metric is filled.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from skybench import (host, probe, qgen, spans, tpchgen,  # noqa: E402
                      work, workload)
from skybench.reference import compare, tpch as reference  # noqa: E402

# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# seconds a query still running at the window's close may take to answer
GRACE_S = 120.0
THREADS = 8
# what the harness builds and marks in its checkout
BUILT = ROOT / "build" / "skybench"


def log(msg: str) -> None:
    print(f"[skybench] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"skybench: {msg}", file=sys.stderr, flush=True)
    return 2


def _caches() -> None:
    """Every cache a library may write, at a fixed path in the checkout
    (the program's own kernels build into ``build/torch_ext``)."""
    base = BUILT
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def _metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "skybench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What one run saw, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def reports(self, rec: dict) -> list:
        return self.recorder.reports(rec["text"])

    def kind_of_qid(self, qid: str) -> str | None:
        return self.kind_of_text.get(self.recorder.text_of.get(qid))

    def pipelines_in_window(self):
        with self.recorder.lock:
            items = [(qid, t, r) for qid, reps in
                     self.recorder.pipelines.items() for t, r in reps]
        return [(q, t, r) for q, t, r in items
                if self.t_open <= t <= self.t_close]


def _drive(client, lists, t_close, records, lock, c):
    for q, p, text in lists[c]:
        start = time.perf_counter()
        if start >= t_close:
            return
        rec = {"client": c, "q": q, "params": p, "text": text,
               "start": start, "end": None, "rows": None, "error": None,
               "request_id": None}
        try:
            rec["rows"], rec["request_id"] = client.run(text)
        except Exception as e:  # noqa: BLE001 - a failed query is counted
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["end"] = time.perf_counter()
        with lock:
            records.append(rec)


class GcPauses:
    """Collections of the interpreter's garbage collector, by generation:
    how many and the seconds they held every thread."""

    def __init__(self):
        self.n, self.s, self._t = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.n[info["generation"]] += 1
            self.s[info["generation"]] += time.perf_counter() - self._t


def _warm(client, texts: list[str], n: int) -> None:
    """Run ``texts`` through ``client`` on ``n`` threads; any failure
    fails the run."""
    with ThreadPoolExecutor(n) as pool:
        for f in [pool.submit(client.run, t) for t in texts]:
            f.result()


def _gap_label(run: Run, host_t: float) -> str:
    """What the clients' queries were doing at host time ``host_t``, and
    in a run with spans, the leaf spans of any query open then."""
    rec = run.recorder
    busy = []
    for r in run.records:
        if r["start"] <= host_t and (r["end"] is None or r["end"] > host_t):
            with rec.lock:
                qid = rec.qid_of.get(r["text"])
                states = list(rec.states.get(qid, []))
                pipes = sum(1 for t, _ in rec.pipelines.get(qid, [])
                            if t <= host_t)
            state = "QUEUED"
            for t, s in states:
                if t <= host_t:
                    state = s
            busy.append(f"{r['q']} {state.lower()}"
                        + (f" ({pipes} pipelines done)" if pipes else ""))
    label = ", ".join(sorted(busy)) or "no query in flight"
    if run.spans:
        names = sorted({n for _, n, _ in spans.open_at(run, host_t)})
        label += "; in " + (", ".join(names) if names else "no span")
    return label


def _roofline_count(run: Run) -> dict:
    """How ``kernels.fused_roofline`` counted the fused pipelines of the
    window (``skybench.work``): the bound summed as the reader sums it,
    beside the scan-fed formula summed over every pipeline, and each
    exchange-fed pipeline's producers (at most ten)."""
    bound = scan_fed = 0.0
    n = 0
    fed = []
    for q, rep, feeders, b in work.fused_pipelines(run):
        n += 1
        bound += b
        scan_fed += work.bound_s(q, rep.kernel_fragments, rep.n_fragments,
                                 run.table_rows)
        if feeders:
            fed.append({"q": q, "pid": rep.pid,
                        "fused": rep.kernel_fragments,
                        "fragments": rep.n_fragments, "bound_s": b,
                        "exchange_rows": [work.exchange_rows(
                            p, rep.kernel_fragments, rep.n_fragments)
                            for p in feeders]})
    return {"pipelines": n, "exchange_fed": len(fed), "bound_s": bound,
            "scan_fed_formula_s": scan_fed, "fed": fed[:10]}


def _breakdown(run: Run) -> dict:
    tr = run.trace
    ops = sorted(tr.kernel_seconds().items(), key=lambda kv: -kv[1][0])
    gaps = tr.gaps()[:10]
    return {"device_ops": [[n[:160], s] for n, (s, _) in ops[:10]],
            "idle_gaps": [[_gap_label(run, tr.host_time((a + b) / 2))
                           [:200], b - a] for a, b in gaps]}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m skybench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) or cpu (a rehearsal)")
    ap.add_argument("--sf", type=float, default=None,
                    help="scale factor in place of the configuration's "
                         "(a rehearsal)")
    args = ap.parse_args(argv)

    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file():
        return fail(f"{bench_file} not found")
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = workload.load(cell["traffic"], BENCH)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = [m for m in bench[kind]
               if args.workload in m.get("workloads", [args.workload])]
    sf = args.sf if args.sf is not None else float(cfg["scale_factor"])

    _caches()
    import torch
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            return fail("no CUDA device")
        if torch.cuda.device_count() < int(cell["chips"]):
            return fail(f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell needs {cell['chips']}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        return fail(f"the program is not in this checkout ({src})")
    sys.path.insert(0, str(src))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != \
            (src / "repro_torch").resolve():
        return fail(f"repro_torch imported from {repro_torch.__file__}")
    from repro_torch.core.events import QueryObserver
    from repro_torch.storage.object_store import ObjectStore
    from skybench import loader
    if on_card:
        log(f"device {torch.cuda.get_device_name(0)}; "
            f"{_power_limit() or 'power limit not read'}; torch "
            f"{torch.__version__} cuda {torch.version.cuda}")

    # -- the kernels the clients' lists need: a scan kernel per
    # parameter set of each query the port compiles per program, run on
    # a small copy of the tables, while the cell's tables are made from
    # the seed and loaded through the port's writer. A checkout's first
    # run compiles every set the traffic can draw, so that a later run
    # with any seed loads its sets and compiles none
    mod = importlib.import_module(f"skybench.clients.{cfg['client']}")
    from skybench.clients.session import Client as SessionClient
    lists = workload.client_lists(traffic, args.seed)
    warm_sf = float(cfg["warm_scale_factor"])
    warm_store = ObjectStore()
    warm_catalog = loader.load(warm_store, tpchgen.generate(
        warm_sf, args.seed), warm_sf, cfg["row_group_rows"])
    compiled_all = BUILT / f"scan-kernels-{device.type}.done"
    warm_qs = [q for q in cfg["warm_every_parameter_set"]
               if q in traffic["mix"]]
    if compiled_all.is_file():
        texts = sorted({text for lst in lists for q, _, text in lst
                        if q in warm_qs})
    else:
        texts = [qgen.render(q, p) for q in warm_qs
                 for p in [qgen.VALIDATION[q]] + qgen.space(q)]

    def scan_kernels() -> float:
        t = time.perf_counter()
        warm = SessionClient(
            dict(cfg, session=dict(cfg["session"],
                                   max_concurrent_queries=THREADS)),
            warm_store, warm_catalog, device, QueryObserver())
        try:
            _warm(warm, texts, THREADS)
        finally:
            warm.close()
        return time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(1) as side, ThreadPoolExecutor(THREADS) as pool:
        kernels_s = side.submit(scan_kernels)
        parts = tpchgen.generate(sf, args.seed, cfg.get("n_parts"), pool)
        store = ObjectStore()
        catalog = loader.load(store, parts, sf, cfg["row_group_rows"], pool)
        tables_s = time.perf_counter() - t
        kernels_s = kernels_s.result()
    BUILT.mkdir(parents=True, exist_ok=True)
    compiled_all.touch()
    tables = {name: tpchgen.concat(p) for name, p in parts.items()}
    del parts, warm_store, warm_catalog
    rows = {name: len(next(iter(c.values()))) for name, c in tables.items()}
    log(f"tables at SF {sf:g} from seed {args.seed} in {tables_s:.3f} s: "
        f"lineitem {rows['lineitem']} rows, orders {rows['orders']}, "
        f"{len(catalog.tables['lineitem'].files)} lineitem partitions")
    loaded = probe.counters()["loaded"]
    log(f"scan kernels of {len(texts)} parameter sets in {kernels_s:.3f} s "
        f"(beside the tables; both {time.perf_counter() - t:.3f} s): "
        f"{len(loaded)} loaded, "
        f"{sum(1 for o, _, _ in loaded if o == 'nvrtc')} compiled "
        f"({sum(ms or 0 for _, ms, _ in loaded):.1f} ms of NVRTC)")

    # -- the cell's client, warmed with the validation texts
    t = time.perf_counter()
    recorder = probe.make_recorder()
    client = mod.Client(cfg, store, catalog, device, recorder)
    recorder.wrap_submit(client.session)
    n_clients = int(traffic["clients"])
    _warm(client, [qgen.render(q, qgen.VALIDATION[q])
                   for q in sorted(traffic["mix"])], THREADS)
    log(f"validation texts of {sorted(traffic['mix'])} through the "
        f"{cfg['client']} client in {time.perf_counter() - t:.3f} s")

    kind_of_text = {text: q for lst in lists for q, _, text in lst}
    records: list[dict] = []
    lock = threading.Lock()
    trace = None
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        from skybench.trace import DeviceTrace
        trace = DeviceTrace(torch, device)
        trace.start()
    span_rec = None
    if args.trace:
        span_rec = spans.make_span_recorder()
        client.session.add_observer(span_rec)
    before = probe.counters()
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    log(f"threads at the window's open: {threading.active_count()} "
        f"Python, {len(host.threads())} in all")
    threads_open = host.threads()
    cpu_open = time.process_time()
    t_open = time.perf_counter()
    setup_s = t_open - T0
    t_close = t_open + args.seconds
    threads = [threading.Thread(target=_drive, daemon=True,
                                args=(client, lists, t_close,
                                      records, lock, c),
                                name=f"skybench-client{c}")
               for c in range(n_clients)]
    for th in threads:
        th.start()
    time.sleep(max(0.0, t_close - time.perf_counter()))
    if trace is not None:
        trace.close_window()
    gc.callbacks.remove(pauses)
    cpu_s = time.process_time() - cpu_open
    threads_close = host.threads()
    after = probe.counters()
    window_s = time.perf_counter() - t_open if trace is None \
        else trace.window_s
    deadline = time.perf_counter() + GRACE_S
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    hung = sum(th.is_alive() for th in threads)
    if trace is not None:
        trace.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    acks = client.acknowledged()
    if not hung:
        client.close()
    del client
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- every answer against the reference
    with lock:
        records = sorted(records, key=lambda r: r["start"])
    t = time.perf_counter()
    ref = reference.Tables(tables)

    def judge(rec):
        if rec["error"] is not None:
            return rec["error"], float("inf")
        want = reference.answer(ref, rec["q"], rec["params"])
        return compare.judge(rec["q"], rec["rows"], want)

    with ThreadPoolExecutor(4) as pool:
        verdicts = list(pool.map(judge, records))
    limit = float(cfg["check"]["max_rel_gap"])
    worst, wrong = 0.0, []
    for rec, (why, gap) in zip(records, verdicts):
        rec["ok"] = why is None and gap <= limit
        if why is None:
            worst = max(worst, gap)
        else:
            wrong.append(f"{rec['q']} {rec['params']}: {why}")
        rec["rows"] = None
    log(f"reference: {len(records)} answers judged in "
        f"{time.perf_counter() - t:.3f} s")
    acked = {a["request_id"]: a for a in acks}
    not_succeeded = sum(1 for r in records if r["request_id"] is not None
                        and (acked.get(r["request_id"]) or {}).get(
                            "status") != "SUCCEEDED")
    done = [r for r in records if r["ok"] and r["end"] <= t_close]
    run = Run(records=records, done=done, window_s=window_s,
              setup_s=setup_s, t_open=t_open, t_close=t_close,
              recorder=recorder, acks=acks, trace=trace,
              done_requests={r["request_id"] for r in done},
              kind_of_text=kind_of_text, table_rows=rows,
              spans=None if span_rec is None else span_rec.spans,
              launches_in_window={
                  k: v - before["launches"].get(k, 0)
                  for k, v in after["launches"].items()})

    # -- what the earlier lines report
    in_window = [r for r in records if r["end"] <= t_close]
    reps = [p for r in in_window for p in run.reports(r)]
    log(f"window {window_s:.3f} s: {len(records)} queries sent, "
        f"{len(in_window)} answered in it, {len(done)} with the "
        f"reference's rows; by query "
        + json.dumps({q: sum(r['q'] == q for r in done)
                      for q in sorted(traffic['mix'])}))
    log(f"client wait samples: {len(done)}; median s by query "
        + json.dumps({q: round(float(np.median(
            [r['end'] - r['start'] for r in done if r['q'] == q])), 4)
            for q in sorted(traffic['mix'])
            if any(r['q'] == q for r in done)})
        + f"; by client {[sum(r['client'] == c for r in done) for c in range(n_clients)]}")
    log(f"garbage collections in the window by generation: {pauses.n}, "
        f"{[round(x, 4) for x in pauses.s]} s")
    log(f"this process's CPU in the window: {cpu_s:.3f} s "
        f"({os.cpu_count()} CPUs); by thread "
        + json.dumps(host.by_thread(threads_open, threads_close)))
    spent = sum(sum(r["client"] == c for r in records) == len(lists[c])
                for c in range(n_clients))
    log(f"clients that sent their whole list ({len(lists[0])} queries) "
        f"before the close: {spent}")
    log(f"pipelines served from the result cache: "
        f"{sum(p.cache_hit for p in reps)}; shared with a running peer: "
        f"{sum(p.deduped for p in reps)}; stragglers re-triggered: "
        f"{recorder.stragglers}")
    new = after["loaded"][len(before["loaded"]):]
    log(f"scan kernels loaded in the window: {len(new)}, compiled "
        f"{sum(1 for o, _, _ in new if o == 'nvrtc')}")
    log(f"kernel launches in the window: "
        + json.dumps(run.launches_in_window))
    if acks:
        log(f"service: {len(acks)} requests acknowledged, "
            f"{sum(a['status'] == 'SUCCEEDED' for a in acks)} SUCCEEDED "
            f"in the ledger")
    if trace is not None:
        log(f"card: busy {trace.busy_s(whole=True):.6f} s of "
            f"{trace.span_s:.6f} s, from the window's open until the "
            f"{len(records)} queries sent in it answered")
    if args.trace and trace is not None:
        from skybench import peaks
        log(f"peaks: {peaks.HBM_BYTES_PER_S:.4g} B/s, FP64 "
            f"{peaks.FP64_FLOPS:.4g} flop/s (at {peaks.POWER_LIMIT_W:g} W);"
            f" this card: {_power_limit() or 'power limit not read'}")
        ks = trace.kernel_seconds()
        log(f"profiler: {len(trace.events)} device activities, busy "
            f"{trace.busy_s():.6f} s of {trace.window_s:.6f} s; main scan "
            f"and join kernels recorded "
            f"{sum(c for n, (_, c) in ks.items() if n.startswith('spec_') or 'join_probe_kernel' in n)}")
    if args.trace:
        log("roofline count " + json.dumps(_roofline_count(run)))
        if run.spans is not None:
            log(f"spans recorded: {len(run.spans)}; a query answered in "
                f"the window sent "
                + json.dumps(spans.by_name_per_query(run)))
    for w in wrong[:10]:
        log(f"wrong: {w}")

    values = {}
    for m in metrics:
        v = _metric_reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    loaded_mods = sorted({n.split(".")[0] for n in sys.modules}
                         & set(FORBIDDEN))
    if loaded_mods:
        return fail(f"the process holds {loaded_mods} after the window")

    failed = sum(1 for r in records if not r["ok"]) + hung
    checks = {
        "wrong_answers": {"value": len(wrong), "limit": 0},
        "max_rel_gap": {"value": worst, "limit": limit},
        "failed_queries": {"value": failed, "limit": 0},
        "unanswered": {"value": hung, "limit": 0},
    }
    if cfg["client"] == "service":
        checks["ledger_not_succeeded"] = {"value": not_succeeded,
                                          "limit": 0}
    correct = bool(records) and all(
        c["value"] <= c["limit"] for c in checks.values())
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": platform.processor() or "cpu",
               "count": 0, "memory_peak_bytes": None}
    result = {"correct": correct, "attempted": len(records) + hung,
              "failed": failed, "metrics": values, "device": dev}
    if args.trace and trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = _breakdown(run)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
