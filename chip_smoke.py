"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--phase hash_partition]

Builds the hand-written CUDA kernels from
``src/repro_torch/kernels/csrc`` (eight libraries, one nvcc each, in
parallel; it fails unless the bf16 attention library's SASS holds HGMMA
and the SSD scan's HMMA, tensor-core, instructions; the scan-aggregate
kernels compile per program with NVRTC at their first call,
``kernels/specialise.py``, and it prints each program's compile time,
its registers and its local memory, and fails if a second call compiles
again or a kernel has local memory), then drives the port's main path at SF 1 through
``repro_torch.api.connect()`` (device: the card): TPC-H Q6, Q1 and a
grouped min/max query (the scan-aggregate kernels); Q12, Q14 and Q19,
broadcast joins whose join stage runs the join-probe kernel; the
selective repartition join of the semi-join tests, grouped by a
dictionary-coded column, whose probe scan runs the Bloom-probe kernel
and whose join stage runs the join-probe kernel, and the same join
grouped by ``l_orderkey`` (Bloom kernel; its later stages have no kernel
arm in either package); Q12 again as a repartition join (the join kernel
over two exchange leaves); a GROUP BY ``l_orderkey`` over lineitem,
whose stage-0 fragment runs the sort-aggregate kernel on 2^23 rows; and
TPC-H Q3, whose final stage runs the top-k kernel. It checks that every
fragment of each kernel pipeline ran its CUDA kernel, that no stage of
these queries waits for a kernel of a later slice, and that the rows
equal the port's oracle; then it holds each kernel against its plain
torch version at the main path's shapes (plus the first 2^20 rows, the
whole table and the edge cases) and times both; for the scan, join and
Bloom kernels also the profiler's device time of each kernel a call
launches beside the event window (a Bloom call must be one CUDA launch,
and the share of valid rows past the filter's first probe is logged),
and for the join the same rows through the
other forms of its program (unsplit, a probe predicate that rejects or
accepts every row, the residual alone). Then the path of the four
kernels no query reaches: it drives ``repro_torch.kernels.ops``'
``flash_attention`` (granite-3-2b at 4096 and 32768 tokens, hymba-1.5b's
window), ``ssd_scan`` (mamba2-130m, hymba-1.5b's mixer, and the chunk-
parallel split's edges: one chunk, chunk 1024, S not a multiple of the
chunk, one head), ``filter_agg`` (TPC-H Q6 over the SF 1 lineitem
columns, against the query's revenue; then at 1, 3 and 1,000,003 rows
and as views at storage offset 1, and a second call's bits) and
``groupby_onehot`` (Q1's group id) with their launch counts reset, then
holds each against its plain version and times it beside its bound and,
where one PyTorch call computes the same function, that call; the SSD
scan, Q6 and the grouped sums also with each kernel's device time, the
SSD scan with its executed against its needed operations.
After the sort kernels, the exchange's partition
(``hash_partition_phase``): Q3 with its joins hashed into 9 partitions,
one ``hash_partition`` launch for each producer partitioned on the card,
and the kernel against its plain version bit for bit at an SF 10 Q3
producer's shape; ``--phase hash_partition`` runs that phase alone over
an SF 1 session of its own.
Right after the query phase, the service tier's path
(``service_phase``, launch counts reset around it): two tenants' fleet
of the eight statements above through a ``QueryService`` with the
result cache off, and the selective join through a second service over
the repartition planner, each request SUCCEEDED with the oracle's rows
and every kernel launched for its fragments; a two-node DAG whose
second node is served from the first's results; two orphaned requests
(ADMITTED, RUNNING) recovered by a new instance with one clean run's
invocations; and ``python -m repro_torch.launch.sql`` on the card as a
subprocess. The top-k is also timed beside library sorts of its packed
key. Before the kernel phases, a profile of the sort-aggregate's and the
bf16 attention's main calls, kernel by kernel (torch.profiler). Last,
the model stack's serving path (``model_phase``, float32, TF32 off,
launch counts reset around it): granite-3-2b at full width and depth
through ``repro_torch.launch.serve.run_serving`` (batch 4, 64 prompt
tokens, 32 new), its prefill and first decode logits against the card's
own full forward, timed beside the bytes a decode step reads and the
operations prefill does; then the card against the port on the CPU on
one set of parameters: granite-3-2b at its published widths cut to 2
layers, mamba2-130m whole, and each of the ten architectures' reduced
configs. Then the training half (``train_phase``, float32, TF32 off,
launch counts reset around it; none may launch): granite-3-2b whole
through the trainer's own step (``launch/train.make_trainer``, remat
on) for three steps of 8 × 128 tokens, timed beside its 6·N·D and AdamW
bound, with its peak memory and a warm step's device busy time, after
holding its gradients with remat against without and two microbatches
against one; one train step on the card against the CPU port (granite-
3-2b and mamba2-130m at their published widths cut to 2 layers, and
the ten reduced configs); and ``launch/train.run_training`` at
mamba2-130m whole failing after its step-1 checkpoint and resumed from
it, with the checkpoint's save and restore MB/s. Last, the dry run
(``dryrun_phase``, launch counts reset around it; none may launch):
every TPC-H query planned again through the query phase's session with
no worker invoked, every (arch × shape) traced at full width on ``meta``
over the card, 16×16 and 2×16×16 meshes by ``repro_torch.launch.dryrun``
in worker processes that see no card (no cell in error, the card's
allocated memory unchanged), and one real step on the card of each cell
whose traced peak fits it, its measured peak memory beside the traced
one. Last, the model stack over a ``DeviceMesh`` (``mesh_phase``, float32,
TF32 off, launch counts reset around it; none may launch): a process
group of one rank over NCCL in this process and the one-card (data 1,
model 1) mesh, every parameter, optimizer-state and cache leaf a
DTensor: granite-3-2b whole served (batch 4, 64 prompt tokens, 31
decode steps) and one full-width train step (8 × 128, remat) against
the port without a mesh on the card, with both warm times and peak
memory; the ten reduced configs' train, prefill and decode steps
likewise; a checkpoint round trip of the sharded training state at
granite-3-2b reduced (saved leaf by leaf, restored, laid out again and
stepped, bit for bit against the run that never stopped, its objects
byte for byte the gathered state's, save and restore times beside the
gathered state's); and, on a machine with four cards, the 2×2 (data,
model) mesh over four processes against the one-card results, the
round trip included (else it logs that it was not run). Exits nonzero
on any failure. The last six lines are JSON: the model phase, the train
phase, the dry run, the mesh phase, the kernel table, then
``{"ok": true, "device": ...}``. """

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM5 HBM3 (data sheet)
FP64_FLOPS = 34e12             # H100 SXM5 FP64 on the CUDA cores (data sheet)
# H100 SXM5 float32 rate outside the tensor cores (data sheet): at least
# the 32-bit integer rate, so the Bloom kernel's bound stays a least time
INT32_OPS = 67e12
FP32_FLOPS = 67e12             # H100 SXM5 float32 on the CUDA cores
BF16_FLOPS = 989e12            # H100 SXM5 dense bf16 on the tensor cores
TF32_FLOPS = 494.7e12          # H100 SXM5 dense TF32 on the tensor cores
RTOL = ATOL = 1e-9             # as the reference's row parity tests
REPS = 25
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
# the selective join of the semi-join tests (tests/test_semijoin.py),
# grouped by a dictionary-coded column (its join and merge stages are
# then direct-strategy aggregates, the join stage on the join kernel) and,
# as there, by l_orderkey (its join stage is a sort-strategy aggregate
# over a join, on the port's own sort_agg arm over joins, which the
# reference's dispatch misses; its merge stage ends in a project, no arm)
SELECTIVE_JOIN = (
    "select o_orderpriority, sum(l_extendedprice) as rev "
    "from lineitem, orders "
    "where l_orderkey = o_orderkey and o_totalprice > 500000 "
    "group by o_orderpriority")
SELECTIVE_JOIN_BY_ORDERKEY = SELECTIVE_JOIN.replace(
    "o_orderpriority", "l_orderkey")
# the reference's sort-aggregate coverage query (BENCH_pr9.json's
# "sortagg" row): a GROUP BY over a key that is not dictionary coded
SORTAGG_SQL = ("select l_orderkey, sum(l_quantity) as s, count(*) as c "
               "from lineitem group by l_orderkey order by l_orderkey")
KERNELS = {   # dispatch kernel name → (wrapper module attr, CUDA source, TPU kernel)
    "filter_agg": ("fused_filter_agg", "scan_spec.cuh",
                   "src/repro/kernels/filter_agg.py:134"),
    "groupby_onehot": ("fused_groupby", "scan_spec.cuh",
                       "src/repro/kernels/groupby_onehot.py:118"),
    "segmented_minmax": ("fused_groupby_minmax", "scan_spec.cuh",
                         "src/repro/kernels/segmented_minmax.py:90"),
    "join_probe_agg": ("fused_join_probe_agg", "join_probe.cu",
                       "src/repro/kernels/join_probe.py:105"),
    "bloom_filter": ("fused_bloom_filter", "bloom.cu",
                     "src/repro/kernels/bloom.py:219"),
    "sort_agg": ("fused_sort_agg", "sort_agg.cu",
                 "src/repro/kernels/sort_agg.py:92"),
    "topk": ("fused_topk", "topk.cu", "src/repro/kernels/topk.py:43"),
}
# the kernels no query reaches: ops wrapper → (CUDA source, TPU kernel,
# launch counter)
STANDALONE = {
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:88",
                        "flash_attention"),
    "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:65",
                 "ssd_scan"),
    "filter_agg": ("filter_agg_q6.cu", "src/repro/kernels/filter_agg.py:61",
                   "filter_agg_q6"),
    "groupby_onehot": ("groupby_onehot.cu",
                       "src/repro/kernels/groupby_onehot.py:52",
                       "groupby_onehot"),
}
# the CUDA kernels one join-probe call launches, once each
JOIN_KERNELS = {"join_probe_kernel": 1, "reduce_partials_kernel": 1}
LAUNCH_NAME = {"filter_agg": "filter_agg", "groupby_onehot": "groupby",
               "segmented_minmax": "groupby_minmax",
               "join_probe_agg": "join_probe_agg",
               "bloom_filter": "bloom_filter", "sort_agg": "sort_agg",
               "topk": "topk"}


def log(*a) -> None:
    print(*a, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from repro_torch.kernels import ext
    t0 = time.perf_counter()
    built = ext.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    for name in ext.SOURCES:
        for line in ext.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # the bf16 attention kernel reached the tensor cores
    hgmma = ext.sass("flash_attention").count("HGMMA")
    log(f"flash_attention SASS: {hgmma} HGMMA instructions")
    if hgmma < 1:
        raise AssertionError("flash_attention: no HGMMA in its SASS")
    # the SSD scan's products reached the TF32 tensor cores
    hmma = ext.sass("ssd_scan").count("HMMA")
    log(f"ssd_scan SASS: {hmma} HMMA instructions")
    if hmma < 1:
        raise AssertionError("ssd_scan: no HMMA in its SASS")

    dev = torch.device("cuda", 0)
    if sys.argv[1:]:
        return phase_alone(torch, ext, dev, sys.argv[1:])
    state, launches = query_phase(torch, ext)
    sessions = state["sessions"]
    try:
        service_phase(torch, ext, state)
        # first: after the many profiler sessions of the device-time
        # columns below, the profiler once recorded no launch of the bf16
        # attention kernel (the cause is not known); a profile that
        # lacks a kernel it expects is taken again, then fails the run
        profile_phase(torch, dev, state)
        # 256 MiB, zeroed before each timed call to flush the 50 MB L2
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        kernels = scan_kernel_phase(torch, dev, state, launches, flush)
        kernels.append(join_kernel_phase(torch, dev, state, launches,
                                         flush))
        kernels.append(bloom_kernel_phase(torch, dev, state, launches,
                                          flush))
        kernels.extend(sort_kernel_phase(torch, dev, state, launches,
                                         flush))
        kernels.append(hash_partition_phase(torch, ext, dev, state, flush))
        t0 = time.perf_counter()
        kernels.extend(standalone_kernel_phase(torch, ext, dev, state,
                                               flush))
        log(f"standalone kernel phase: {time.perf_counter() - t0:.1f} s")
        del state, flush
        log(f"device memory held before the model phase: "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB")
        model = model_phase(torch, ext, dev, smi[0])
        train = train_phase(torch, ext, dev, smi[0])
        # the query phase's main session: its SF 1 catalog is planned
        # again, not made again
        dry = dryrun_phase(torch, ext, dev, smi[0], sessions[0])
    finally:
        for s in sessions:
            s.close()
    mesh = mesh_phase(torch, ext, dev, smi[0])
    log(json.dumps({"model": model}))
    log(json.dumps({"train": train}))
    log(json.dumps({"dryrun": dry}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_alone(torch, ext, dev, argv) -> int:
    """``--phase hash_partition``: that phase alone, over an SF 1 session
    of its own; the last lines are its kernel table and the ok line."""
    if argv != ["--phase", "hash_partition"]:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    from repro_torch.api import connect
    from repro_torch.sql import oracle
    from repro_torch.sql.logical import Binder
    from repro_torch.sql.parser import parse
    from repro_torch.sql.queries import QUERIES
    from repro_torch.sql.rules import optimize

    session = connect(quota=16, device=dev)
    try:
        catalog = session.ensure_tpch(sf=1)
        tables = _read(session, catalog, ("lineitem", "orders", "customer"))
        lqp, _ = Binder(catalog).bind(parse(QUERIES["q3"]))
        state = {"session": session, "catalog": catalog,
                 "lineitem": tables["lineitem"],
                 "truth": {"q3": oracle.run(optimize(lqp), tables)}}
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        row = hash_partition_phase(torch, ext, dev, state, flush)
    finally:
        session.close()
    log(json.dumps({"kernels": [row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- query phase: the port's main path ----------------------------------------

def _sorted_rows(cols):
    import numpy as np
    keys = sorted(cols)
    arrs = [np.asarray(cols[k], np.float64) for k in keys]
    order = np.lexsort(arrs)
    return {k: a[order] for k, a in zip(keys, arrs)}


def _assert_rows(got, want, ctx):
    import numpy as np
    a, b = _sorted_rows(got), _sorted_rows(want)
    if sorted(a) != sorted(b):
        raise AssertionError(f"{ctx}: columns {sorted(a)} != {sorted(b)}")
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{ctx} :: {k}")


def _read(session, catalog, names):
    import numpy as np
    from repro_torch.storage import InputHandler
    ih = InputHandler(session.store)
    out = {}
    for name in names:
        meta = catalog.tables[name]
        parts = [ih.read_table(f)[0] for f in meta.files]
        out[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                     for c in meta.schema}
    return out


def _op_kinds(op: dict) -> list:
    kinds = [op["t"]]
    for k in ("child", "probe", "build"):
        if k in op:
            kinds.extend(_op_kinds(op[k]))
    return kinds


def _check_host_kills(session, ran) -> int:
    """Each Bloom fragment killed exactly the rows the host probe of its
    filter kills on the rows it scanned; returns the total."""
    import numpy as np
    from repro_torch.kernels import bloom
    from repro_torch.storage import InputHandler
    ih = InputHandler(session.store)
    total = 0
    for r in ran:
        spec = r["spec"]
        (key,) = spec["semijoin"]["key"]
        parts, _ = ih.read_tables(spec["scan_units"], [key], [])
        keys = np.concatenate([t[key] for t in parts])
        f = bloom.bloom_from_wire(spec["semijoin"])
        hit = bloom.bloom_probe_np(keys.astype(np.uint32), f["words"],
                                   f["bits"], f["k"])
        if r["semijoin_killed"] != int((~hit).sum()):
            raise AssertionError(f"Bloom fragment killed "
                                 f"{r['semijoin_killed']} rows, the host "
                                 f"probe {int((~hit).sum())}")
        total += r["semijoin_killed"]
    return total


def _kernel_pipeline(name, kernel, res, ran, analyze):
    """The one pipeline of ``res`` that runs ``kernel``; every one of its
    fragments ran it, and EXPLAIN ANALYZE says so. A Bloom probe wraps
    the fragments of the pipeline whose semi-join filter was applied."""
    if kernel == "bloom_filter":
        kpipes = [p for p in res.stats.pipelines
                  if (p.semijoin or {}).get("applied")]
    else:
        kpipes = [p for p in res.stats.pipelines if p.kernel == kernel]
    if len(kpipes) != 1:
        raise AssertionError(
            f"{name}: {kernel} pipelines "
            f"{[(p.kernel, p.kernel_fragments) for p in kpipes]}")
    p0 = kpipes[0]
    # a straggler's duplicate invocation runs its fragment again
    fragments = {r["spec"]["fragment"] for r in ran}
    if p0.kernel_fragments != p0.n_fragments or \
            len(fragments) != p0.n_fragments:
        raise AssertionError(f"{name}: {p0.kernel_fragments} of "
                             f"{p0.n_fragments} fragments on {kernel}, "
                             f"{sorted(fragments)} ran it")
    line = ("semijoin: pushed est≈" if kernel == "bloom_filter" else
            f"kernel: {kernel} × {p0.n_fragments} fragments")
    if line not in analyze:
        raise AssertionError(f"{name}: explain_analyze lacks {line!r}")
    return p0


def _capture(ops, captured, current):
    """Wrap the sort kernels' dispatch wrappers so that the first call of
    each query keeps its inputs (no copy, no launch); returns a function
    that restores the wrappers."""
    saved = {k: getattr(ops, KERNELS[k][0]) for k in ("sort_agg", "topk")}

    def wrap(kernel, fn):
        def wrapped(*args, **kw):
            captured.setdefault((current[0], kernel), (args, kw))
            return fn(*args, **kw)
        return wrapped
    for kernel, fn in saved.items():
        setattr(ops, KERNELS[kernel][0], wrap(kernel, fn))

    def restore():
        for kernel, fn in saved.items():
            setattr(ops, KERNELS[kernel][0], fn)
    return restore


def query_phase(torch, ext, *, sf=1, n_parts=None, device=None,
                config=None):
    """The main path. ``config``: the main session's CoordinatorConfig
    (None: the default; at SF 0.01 the default planner folds Q3's final
    into its merge stage, so a rehearsal there passes the benchmark
    suites' planner)."""
    from repro_torch.api import connect
    from repro_torch.core import CoordinatorConfig
    from repro_torch.kernels import ops, specialise
    from repro_torch.sql import oracle
    from repro_torch.sql.logical import Binder
    from repro_torch.sql.parser import parse
    from repro_torch.sql.physical import PlannerConfig
    from repro_torch.sql.queries import QUERIES
    from repro_torch.sql.rules import optimize

    session = connect(quota=16, device=device, config=config)
    t0 = time.perf_counter()
    catalog = session.ensure_tpch(sf=sf, n_parts=n_parts)
    log(f"ensure_tpch(sf={sf}): {time.perf_counter() - t0:.1f} s, device "
        f"{session.device}")
    # repartition joins: every join shuffles both sides (the semi-join
    # tests' planner), in barrier mode with plan-time decisions, and no
    # result cache (Q12's join stage shares its sem hash with the
    # broadcast plan's)
    repart = connect(store=session.store, quota=16, device=device,
                     config=CoordinatorConfig(
                         planner=PlannerConfig(broadcast_threshold_bytes=1,
                                               exchange_partitions=4),
                         use_result_cache=False, pipelined=False,
                         adaptive=False))
    repart.ensure_tpch(sf=sf, n_parts=n_parts)
    tables = _read(session, catalog, ("lineitem", "orders", "part",
                                     "customer"))
    lineitem = tables["lineitem"]
    log(f"lineitem: {len(lineitem['l_orderkey'])} rows, orders "
        f"{len(tables['orders']['o_orderkey'])}, part "
        f"{len(tables['part']['p_partkey'])}")

    # observe the fragments' FragmentStats (and specs) as workers return
    records, lock = [], threading.Lock()

    def observe(s):
        inner = s.handler

        def handler(payload):
            resp, runtime = inner(payload)
            with lock:
                records.append(dict(resp["stats"], spec=payload))
            return resp, runtime
        s.handler = handler
    observe(session)
    observe(repart)

    # (name, sql, session, {kernel its pipelines run: build table of a
    #  broadcast join, whose rows the fragment's rows_in also counts})
    queries = [("q6", QUERIES["q6"], session, {"filter_agg": None}),
               ("q1", QUERIES["q1"], session, {"groupby_onehot": None}),
               ("minmax", MINMAX_SQL, session, {"segmented_minmax": None}),
               ("q12", QUERIES["q12"], session, {"join_probe_agg": "orders"}),
               ("q14", QUERIES["q14"], session, {"join_probe_agg": "part"}),
               ("q19", QUERIES["q19"], session, {"join_probe_agg": "part"}),
               ("semijoin", SELECTIVE_JOIN, repart,
                {"bloom_filter": None, "join_probe_agg": None}),
               ("q12-repart", QUERIES["q12"], repart,
                {"join_probe_agg": None}),
               ("semijoin-orderkey", SELECTIVE_JOIN_BY_ORDERKEY, repart,
                {"bloom_filter": None, "sort_agg": None}),
               ("sortagg", SORTAGG_SQL, session, {"sort_agg": None}),
               ("q3", QUERIES["q3"], session,
                {"sort_agg": None, "topk": None})]
    shapes, specs, frags, captured, current = {}, {}, {}, {}, [None]
    fetched, truth = {}, {}
    restore = _capture(ops, captured, current)
    on_card = session.device.type == "cuda"
    peaks = {}                               # query -> peak MiB allocated
    ext.reset_launches()                     # the main path starts here
    try:
        for name, sql, sess, kernels in queries:
            records.clear()
            current[0] = name
            n_loaded = len(specialise.loaded())
            if on_card:
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            handle = sess.submit(sql)
            res = handle.result(timeout=900)
            wall = time.perf_counter() - t0
            rows = fetched[name] = res.fetch(sess.store)
            analyze = handle.explain_analyze()
            # a probe scan that carries a semi-join filter runs the Bloom
            # kernel in any query; no other kernel may run, and no stage
            # may wait for a kernel of a later slice
            other = {r["kernel"] for r in records if r["kernel"]} - \
                set(kernels) - {"bloom_filter"}
            waiting = [p.kernel_miss_reason for p in res.stats.pipelines
                       if "not yet ported" in (p.kernel_miss_reason or "")]
            if other or waiting:
                raise AssertionError(f"{name}: other kernels {other}, "
                                     f"unported arms {waiting}")
            on = []
            for kernel, build in kernels.items():
                ran = [r for r in records if r["kernel"] == kernel]
                p0 = _kernel_pipeline(name, kernel, res, ran, analyze)
                if kernel == "bloom_filter":
                    killed = _check_host_kills(sess, ran)
                    if not killed or killed != p0.semijoin_killed or \
                            f"actual={killed} rows killed" not in analyze:
                        raise AssertionError(
                            f"{name}: {killed} rows killed, report "
                            f"{p0.semijoin_killed}")
                    log(f"query {name}: {killed} probe rows killed by the "
                        f"Bloom kernel = the host probe's count")
                    specs[name] = ran[0]["spec"]
                if name == "q12-repart" and any(
                        _op_kinds(r["spec"]["op"]).count("scan_exchange")
                        != 2 for r in ran):
                    raise AssertionError("q12-repart: join fragments do "
                                         "not read two exchange leaves")
                n_build = len(next(iter(tables[build].values()))) \
                    if build else 0
                shapes[(name, kernel)] = \
                    max(r["rows_in"] for r in ran) - n_build
                frags[(name, kernel)] = p0.n_fragments
                on.append(f"{len(ran)} on {kernel}, compute_s "
                          f"{sum(r['compute_s'] for r in ran):.6f} s")
            lqp, _ = Binder(catalog).bind(parse(sql))
            truth[name] = oracle.run(optimize(lqp), tables)
            _assert_rows(rows, truth[name], name)
            mem = ""
            if on_card:
                peaks[name] = torch.cuda.max_memory_allocated() / 2**20
                mem = (f", peak device memory {peaks[name]:.1f} MiB "
                       f"({held / 2**20:.1f} MiB held before it)")
            new = specialise.loaded()[n_loaded:]
            if new:
                mem += (f", {len(new)} scan kernel(s) loaded in its "
                        f"untimed first calls: " + ", ".join(
                            f"{k.kind} " + (f"NVRTC {k.compile_ms:.1f} ms"
                                            if k.origin == "nvrtc"
                                            else "from the disk cache")
                            for k in new))
            log(f"query {name}: wall {wall:.3f} s, compute_s "
                f"{sum(r['compute_s'] for r in records):.6f} s over "
                f"{len(records)} fragments ({'; '.join(on)}), "
                f"rows = oracle{mem}")
    except BaseException:
        session.close()
        repart.close()
        raise
    finally:
        launches = ext.launches()            # ... and ends here
        restore()
    log(f"launches on the main path: {launches}")
    if on_card:
        top = max(peaks, key=peaks.get)
        log(f"peak device memory {peaks[top]:.1f} MiB (query {top})")
        for kernel in KERNELS:
            if launches.get(LAUNCH_NAME[kernel], 0) < 1:
                session.close()
                repart.close()
                raise AssertionError(f"{kernel}: no launch on the main path")
        # one launch per fragment at least (a pipeline's concurrent first
        # calls each take the untimed warm-up, so launches may exceed it)
        for (name, kernel), n in frags.items():
            if kernel in ("sort_agg", "topk") and \
                    launches[LAUNCH_NAME[kernel]] < n:
                session.close()
                repart.close()
                raise AssertionError(f"{name}: {kernel} launched "
                                     f"{launches[LAUNCH_NAME[kernel]]} "
                                     f"times for {n} fragments")
    rows = {"filter_agg": shapes[("q6", "filter_agg")],
            "groupby_onehot": shapes[("q1", "groupby_onehot")],
            "segmented_minmax": shapes[("minmax", "segmented_minmax")]}
    return {"lineitem": lineitem, "tables": tables, "rows": rows,
            "join_rows": {q: shapes[(q, "join_probe_agg")]
                          for q in ("q12", "q14", "q19")},
            "bloom_rows": shapes[("semijoin", "bloom_filter")],
            "bloom_spec": specs["semijoin"], "catalog": catalog,
            "sort_input": captured[("sortagg", "sort_agg")],
            "sort_q3_input": captured[("q3", "sort_agg")],
            "topk_input": captured[("q3", "topk")], "sf": sf,
            "q6_rows": fetched["q6"], "truth": truth, "n_parts": n_parts,
            "config": config,
            "session": session, "sessions": (session, repart)}, launches


# -- service phase: the query service tier on the card ------------------------

# the fleet's statements: query_phase's name → the kernels its pipelines
# run (the SQL is query_phase's)
SERVICE_QUERIES = {"q6": ("filter_agg",), "q1": ("groupby_onehot",),
                   "minmax": ("segmented_minmax",), "q12": ("join_probe_agg",),
                   "q14": ("join_probe_agg",), "q19": ("join_probe_agg",),
                   "q3": ("sort_agg", "topk"), "sortagg": ("sort_agg",)}
SERVICE_TENANTS = (("gold", dict(weight=3.0, deadline_s=30.0)),
                   ("bronze", dict(weight=1.0, budget_cents=100.0)))
# the dead owner's lease in the recovery drive: long enough that no
# compile or wall of this run outlasts a live owner's renewals
ORPHAN_LEASE_S = 3.0


def _q6_year(year):
    from repro_torch.sql.queries import QUERIES
    return QUERIES["q6"].replace("1994-01-01", f"{year}-01-01")


def _submits(session):
    """Wrap ``session.submit`` so that each call's handle is kept beside
    its tenant and SQL (the service keeps a handle only while it runs)."""
    seen, lock, inner = [], threading.Lock(), session.submit

    def submit(sql, *a, **kw):
        handle = inner(sql, *a, **kw)
        with lock:
            seen.append((kw.get("tenant"), sql, handle))
        return handle
    session.submit = submit
    return seen


def _served(ctx, handle, truth, store):
    """A SUCCEEDED request's rows against the oracle; its log line."""
    res = handle.result(timeout=900)
    e = handle.entry()
    if e.status.value != "SUCCEEDED":
        raise AssertionError(f"{ctx}: {e.status.value} {e.error}")
    _assert_rows(res.fetch(store), truth, ctx)
    log(f"service {ctx}: SUCCEEDED, attempt {e.attempt}, wall "
        f"{e.finished_at - e.submitted_at:.3f} s ("
        f"{e.finished_at - e.started_at:.3f} s running), sim latency "
        f"{res.sim_latency_s:.4f} s, {res.cost_cents:.6f} cents, cache hits "
        f"{res.cache_hits}, rows = oracle")
    return res, e


def service_phase(torch, ext, state, *, device=None, cli_device=None):
    """The service tier's path (``repro_torch.service``, then the CLI) on
    query_phase's SF 1 store, with the launch counts set to 0 just before
    it and read just after:

    - a fleet: two tenants (weight 3 with a deadline, weight 1 with a
      budget) each submit query_phase's eight statements to a
      ``QueryService`` over a session with the result cache off (every
      request runs its fragments), four queries at a time, and a second
      service over a session with query_phase's repartition planner
      serves the selective join (the Bloom kernel); every request ends
      SUCCEEDED with the oracle's rows, each pipeline that should run a
      kernel ran it on every fragment, and each kernel's launches cover
      its fragments;
    - a DAG over the cached main session: two copies of Q6 at another
      year, node 1 after node 0, node 1 served from node 0's results;
    - recovery: orphans left ADMITTED and RUNNING by a dead owner, whose
      lease lapses, recovered by a new instance with one clean run's
      invocations;
    - the CLI (``python -m repro_torch.launch.sql``) as a subprocess, on
      the card unless ``cli_device`` says otherwise, started first so it
      overlaps the rest.

    The two fleet sessions run barrier mode: both tenants run the same
    statements at once with no result cache, and a pipelined pipeline's
    partial stream is keyed by its semantic hash, which two live runs of
    one pipeline would share."""
    import dataclasses
    import os
    from repro_torch.api import connect
    from repro_torch.core import CoordinatorConfig
    from repro_torch.service import (QueryService, RequestLedger,
                                     RequestStatus, ServiceHandle,
                                     TenantConfig)
    from repro_torch.sql import oracle
    from repro_torch.sql.logical import Binder
    from repro_torch.sql.parser import parse
    from repro_torch.sql.physical import PlannerConfig
    from repro_torch.sql.queries import QUERIES
    from repro_torch.sql.rules import optimize

    t_phase = time.perf_counter()
    main, store = state["session"], state["session"].store
    sf, n_parts = state["sf"], state["n_parts"]
    base = state["config"] or CoordinatorConfig()
    sqls = dict(QUERIES, minmax=MINMAX_SQL, sortagg=SORTAGG_SQL)
    truth = state["truth"]

    def oracle_rows(sql):
        lqp, _ = Binder(state["catalog"]).bind(parse(sql))
        return oracle.run(optimize(lqp), state["tables"])

    root = Path(__file__).resolve().parent
    cli = [sys.executable, "-m", "repro_torch.launch.sql", "--sf", "0.01",
           "--query", "q6,q12", "--tenant", "smoke", "--deadline", "10"]
    if cli_device is not None:
        cli += ["--device", cli_device]
    proc = subprocess.Popen(cli, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(root / "src")))
    sessions, services = [], []

    def session(config):
        s = connect(store=store, quota=16, device=device, config=config,
                    max_concurrent_queries=4)
        sessions.append(s)
        s.ensure_tpch(sf=sf, n_parts=n_parts)
        return s

    def service(s, namespace, **kw):
        svc = QueryService(s, ledger=RequestLedger(
            store, namespace=namespace, lease_ttl_s=30.0), **kw)
        services.append(svc)
        return svc

    ext.reset_launches()                     # the service path starts here
    try:
        # -- the fleet
        fleet = session(dataclasses.replace(base, use_result_cache=False,
                                            pipelined=False))
        repart = session(CoordinatorConfig(
            planner=PlannerConfig(broadcast_threshold_bytes=1,
                                  exchange_partitions=4),
            use_result_cache=False, pipelined=False, adaptive=False))
        fleet_runs, repart_runs = _submits(fleet), _submits(repart)
        svc = service(fleet, "ledger-fleet", tenants=tuple(
            TenantConfig(name, **kw) for name, kw in SERVICE_TENANTS))
        svc_repart = service(repart, "ledger-repart")
        handles = {(t, q): svc.submit(sqls[q], tenant=t)
                   for t, _ in SERVICE_TENANTS for q in SERVICE_QUERIES}
        handles[("repart", "semijoin")] = svc_repart.submit(SELECTIVE_JOIN)
        for (tenant, q), h in handles.items():
            _served(f"{tenant} {q}", h, truth[q], store)
        for s in (svc, svc_repart):
            s.close()
        fleet_launches = ext.launches()
        want = dict(SERVICE_QUERIES,
                    semijoin=("bloom_filter", "join_probe_agg"))
        by_sql = {sqls[q]: q for q in SERVICE_QUERIES}
        by_sql[SELECTIVE_JOIN] = "semijoin"
        fragments = {}
        runs = [(t or "repart", by_sql[sql], h)
                for t, sql, h in fleet_runs + repart_runs]
        if len(runs) != len(handles):
            raise AssertionError(f"{len(runs)} session runs for "
                                 f"{len(handles)} requests")
        def kernel_of(p):
            # a probe scan whose semi-join filter was applied runs the
            # Bloom kernel on each fragment (its pipeline has no arm)
            if (p.semijoin or {}).get("applied") and not p.kernel:
                return "bloom_filter"
            return p.kernel
        for tenant, q, h in runs:
            pipes = h.stats().pipelines
            for kernel in want[q]:
                ran = [p for p in pipes if kernel_of(p) == kernel]
                if not ran or any(p.kernel_fragments != p.n_fragments
                                  or p.n_fragments < 1 for p in ran):
                    raise AssertionError(
                        f"service {tenant} {q}: {kernel} ran on "
                        f"{[(p.kernel_fragments, p.n_fragments) for p in ran]}"
                        f" fragments of its pipelines")
            for p in pipes:
                if kernel_of(p):
                    fragments[kernel_of(p)] = fragments.get(
                        kernel_of(p), 0) + p.kernel_fragments
        for kernel in KERNELS:
            n = fleet_launches.get(LAUNCH_NAME[kernel], 0)
            if n < max(fragments.get(kernel, 0), 1):
                raise AssertionError(f"service fleet: {kernel} launched {n} "
                                     f"times for {fragments.get(kernel, 0)} "
                                     f"kernel fragments")
        log(f"service fleet: {len(handles)} requests SUCCEEDED = oracle; "
            f"kernel fragments {fragments}; launches {fleet_launches}; "
            f"tenants " + json.dumps({k: {f: v for f, v in t.items()
                                          if f in ("window_spent_cents",
                                                   "admitted_slots",
                                                   "runtime_ema_s",
                                                   "throttled_admissions",
                                                   "degraded_dispatches")}
                                      for k, t in svc.stats()[
                                          "tenants"].items()}))

        # -- a DAG over the cached main session
        dag_sql = _q6_year(1995)
        before = ext.launches().get(LAUNCH_NAME["filter_agg"], 0)
        with service(main, "ledger-dag") as svc_dag:
            n0, n1 = svc_dag.submit_dag([dag_sql, dag_sql], {1: [0]})
            want_rows = oracle_rows(dag_sql)
            _, e0 = _served("dag node 0", n0, want_rows, store)
            r1, e1 = _served("dag node 1", n1, want_rows, store)
        scans = ext.launches().get(LAUNCH_NAME["filter_agg"], 0) - before
        shared = e1.result["cache_hits"] + e1.result["deduped"]
        if scans < 1 or e1.started_at < e0.finished_at or shared < 1:
            raise AssertionError(f"dag: {scans} scan launches, node 1 "
                                 f"started {e1.started_at - e0.finished_at} "
                                 f"s after node 0 ended, {shared} shared")
        log(f"service dag: node 0 launched the scan kernel {scans} times; "
            f"node 1 started {e1.started_at - e0.finished_at:.3f} s after "
            f"node 0 finished, cache hits {r1.cache_hits} + deduped "
            f"{e1.result['deduped']}")

        # -- recovery, exactly once: two orphans of one statement
        rec_sql = _q6_year(1996)
        rec_cfg = dataclasses.replace(base, calibrate_selectivity=False,
                                      pipelined=False)
        dead = RequestLedger(store, namespace="ledger-recovery",
                             lease_ttl_s=ORPHAN_LEASE_S)
        for rid, die_at in (("orphan-admitted", RequestStatus.ADMITTED),
                            ("orphan-running", RequestStatus.RUNNING)):
            dead.submit(rec_sql, request_id=rid)
            dead.claim(rid, "svc-dead")
            if die_at is RequestStatus.RUNNING:
                dead.transition(rid, die_at, if_owner="svc-dead")
            if dead.get(rid).status is not die_at:
                raise AssertionError(f"{rid}: {dead.get(rid).status}")
        lapse = max(e.lease_expires for e in dead.entries()) - time.time()
        time.sleep(max(lapse, 0.0) + 0.05)    # the owner never renews
        rec = session(rec_cfg)
        svc_rec = service(rec, "ledger-recovery")
        rec_rows = oracle_rows(rec_sql)
        for rid in ("orphan-admitted", "orphan-running"):
            _, e = _served(f"recovered {rid}", ServiceHandle(rid, svc_rec),
                           rec_rows, store)
            if e.attempt != 1:
                raise AssertionError(f"{rid}: attempt {e.attempt}")
        svc_rec.close()
        # one clean run of the same statement, on a platform of its own
        clean = session(dataclasses.replace(rec_cfg, use_result_cache=False))
        _assert_rows(clean.sql(rec_sql, timeout=900).fetch(store), rec_rows,
                     "clean run")
        got, solo = rec.platform.invocations, clean.platform.invocations
        if got != solo or svc_rec.recovered_requests != 2:
            raise AssertionError(f"recovery: {got} invocations for two "
                                 f"orphans, a clean run {solo}; recovered "
                                 f"{svc_rec.recovered_requests}")
        log(f"service recovery: 2 orphans (ADMITTED, RUNNING) re-queued and "
            f"run with {got} invocations = one clean run's {solo}")

        # -- the CLI
        out, err = proc.communicate(timeout=300)
        lines = out.splitlines()
        for ln in lines:
            log(f"  cli: {ln}")
        want_dev = (f"[sql] device {cli_device}" if cli_device else
                    f"[sql] device cuda:0 ({torch.cuda.get_device_name(0)})")
        ok = sum("SUCCEEDED (tenant=smoke" in ln for ln in lines)
        if proc.returncode != 0 or ok != 2 or want_dev not in lines:
            raise AssertionError(f"cli: exit {proc.returncode}, {ok} of 2 "
                                 f"SUCCEEDED, {want_dev!r} printed: "
                                 f"{want_dev in lines}\n{err[-3000:]}")
    finally:
        for svc_ in services:
            svc_.kill()
        for s in sessions:
            s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # ... and ends here
    log(f"service phase launches: {ext.launches()}")
    log(f"service phase: {time.perf_counter() - t_phase:.1f} s")


# -- kernel phase: each kernel against its plain version ----------------------

def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _time_ms(torch, fn, flush, reps=REPS):
    """Median of ``reps`` CUDA-event-timed calls after three warm-up
    calls, with the L2 cache flushed before each (the caller meets its
    block cold). The window holds the host's work of the call too."""
    import statistics
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# profiler rows that are no kernel of the call: host operators (their
# device time repeats their kernels'), copies, the profiler's own buffer,
# the flush's fill (an elementwise kernel)
_NOT_KERNELS = ("aten::", "cuda", "Activity", "Memcpy", "Memset")


def _kernel_times(torch, fn, expect, reps=1, flush=None, tries=5):
    """{CUDA kernel: (device ms, launches)} per call of ``fn`` over
    ``reps`` profiled calls after a warm-up call (torch.profiler), the L2
    flushed before each where ``flush`` is given. Every name in
    ``expect`` must be part of a kernel the profile holds: one it lost
    would read as zero device time, so that profile is taken again half
    a second later (the losses come in runs), up to ``tries`` times in
    all, before it raises. The profiler also
    records fewer launches than the calls make at times (PERF.md §7):
    a kernel of ``expect`` (launched ``expect[name]`` times a call) then
    counts its mean time per recorded launch times the launches made."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync(torch)
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            _sync(torch)
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            key = ev.key.split("(")[0]
            if us > 0 and not key.startswith(_NOT_KERNELS) \
                    and "elementwise" not in key:
                ms, n = out.get(key, (0.0, 0))
                out[key] = (ms + us / 1e3, n + ev.count)
        missing = [name for name in expect
                   if not any(name in k for k in out)]
        if not missing:
            break
        msg = (f"profile {attempt} of {tries} holds no launch of "
               f"{', '.join(missing)}; kernels seen: {sorted(out)}")
        if attempt == tries:
            raise AssertionError(msg)
        log(msg + "; profiling again")
        time.sleep(0.5)
    for name, launches in expect.items():
        keys = [k for k in out if name in k]
        made, seen = launches * reps, sum(out[k][1] for k in keys)
        if seen < made:
            log(f"profile holds {seen} of the {made} launches of {name}; "
                f"its time is scaled to {made}")
            for k in keys:
                out[k] = (out[k][0] * made / seen, out[k][1])
    return {k: (ms / reps, n / reps) for k, (ms, n) in out.items()}


def _sizes(n_total, main_rows):
    """The shapes each kernel is held at: the first 2^20 rows of the
    table, the main path's largest fragment, the whole table."""
    return (("2^20", min(1 << 20, n_total)), ("main", main_rows),
            ("all", n_total))


def _compare(got, want, ctx):
    import numpy as np
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        raise AssertionError(f"{ctx}: shape {g.shape} != {w.shape}")
    if g.ndim == 2:                   # grouped: presence counts are exact
        if not np.array_equal(g[..., -1], w[..., -1]):
            raise AssertionError(f"{ctx}: presence differs")
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=ctx)
    finite = np.isfinite(w)
    return float(np.max(np.abs(g[finite] - w[finite]), initial=0.0))


def _equal(got, want, ctx):
    """Bloom verdicts: equal row for row (max |err| 0)."""
    if got.shape != want.shape or not bool((got == want).all()):
        raise AssertionError(f"{ctx}: {int((got != want).sum())} "
                             f"verdicts differ")
    return 0.0


def _program_ops(prog, slot):
    from repro_torch.kernels.program import COL, CONST
    lo, hi = prog.slot_range(slot)
    return sum(1 for op, _ in prog.code[lo:hi].tolist()
               if op not in (COL, CONST))


def _program_work(prog, n_eval, n_pass, n_probe=0):
    """Operations of the expression program: a join's probe predicate on
    ``n_probe`` rows, the predicate on ``n_eval`` rows, the group id, the
    folds and the aggregate arguments on the ``n_pass`` rows that pass
    it."""
    pre = _program_ops(prog, prog.probe_slot) if prog.has_probe_pred else 0
    return n_probe * pre + n_eval * _program_ops(prog, 0) + n_pass * (
        _program_ops(prog, 1) + prog.n_aggs
        + sum(_program_ops(prog, 2 + a) for a in range(prog.n_aggs)))


def _first_use_bytes(stages, nbytes_of):
    """Bytes of columns read in stages: ``stages`` is a list of (column
    names, rows) in the order a kernel reaches them; each column is
    charged ``nbytes_of(name, rows)`` at the first stage that reads it
    (a column the predicate reads is needed for every valid row, one
    only the aggregates read for the rows that pass)."""
    seen, total = set(), 0
    for names, rows in stages:
        for c in sorted(set(names) - seen):
            total += nbytes_of(c, rows)
        seen |= set(names)
    return total


def _bound(nbytes, ops, peak=FP64_FLOPS):
    """Least time of a call that must move ``nbytes`` and do ``ops``:
    the larger of the two over HBM bandwidth and the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return nbytes, max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def _device_ms(torch, call, flush, expect):
    """Device time of each CUDA kernel one call launches (torch.profiler,
    mean of 10 calls, the L2 flushed before each): {kernel: ms}; each
    kernel named in ``expect`` must be among them (:func:`_kernel_times`)."""
    return {k: ms for k, (ms, _) in
            _kernel_times(torch, call, expect, 10, flush).items()}


def _one_launch(torch, flush, ctx, call, kernel):
    """Fail unless one call of ``call`` launches one CUDA kernel, named
    ``kernel``, once (torch.profiler over 10 calls)."""
    k = _kernel_times(torch, call, {kernel: 1}, 10, flush)
    launches = sum(n for _, n in k.values())
    log(f"kernel {ctx}: {launches:g} CUDA launches a call ("
        + ", ".join(f"{name[:40]} x{n:g}" for name, (_, n) in k.items())
        + ")")
    if launches > 1 or any(kernel not in name for name in k):
        raise AssertionError(f"{ctx}: want one launch of {kernel} a call, "
                             f"got {launches:g}: {sorted(k)}")


def _hold(torch, flush, ctx, call, plain, compare, bound, info, *,
          got=None, reps=REPS, library=None, device=None):
    """One kernel at one shape: its result (``got``, where the main path
    already made it) against the plain version's, both timed, the bound
    of the work and (``library``) one PyTorch call of the same function;
    with ``device`` ({kernel name: launches a call}, as
    :func:`_kernel_times` expects), also the profiler's device time of
    each kernel the call launches beside the event window. Returns the
    result row."""
    if got is None:
        got = call()
    want = plain()
    _sync(torch)
    err = compare(got, want, ctx)
    ms = _time_ms(torch, call, flush, reps)
    plain_ms = _time_ms(torch, plain, flush, reps=5)
    lib_ms = _time_ms(torch, library, flush, reps) if library else None
    nbytes, bound_ms, bound_by = bound(got)
    lib = f", library {lib_ms * 1e3:.1f} us" if library else ""
    dev, kernels = "", None
    if device:
        kernels = _device_ms(torch, call, flush, device)
        dev = (f", device {sum(kernels.values()) * 1e3:.1f} us ("
               + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(
                   kernels.items(), key=lambda kv: -kv[1])) + ")")
    log(f"kernel {ctx}: {', '.join(f'{k} {v}' for k, v in info.items())}, "
        f"{ms * 1e3:.1f} us (median of {reps}){dev}, plain "
        f"{plain_ms * 1e3:.1f} us{lib}, {nbytes} B moved, bound "
        f"{bound_ms * 1e3:.1f} us ({bound_by}), "
        f"{100 * bound_ms / ms:.1f}% of bound, max|err| {err:.3g}")
    out = dict(info, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes)
    if kernels is not None:
        out.update(device_ms=sum(kernels.values()), device_kernels=kernels)
    return out


def _row(name, source, replaces, launches, results, main, **extra):
    """A kernel's entry of the JSON line: its main shape's numbers and
    every shape's times."""
    m = results[main]
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "rows": m["rows"], **extra,
        **({"device_ms": m["device_ms"]} if "device_ms" in m else {}),
        "shapes": {k: {kk: v[kk] for kk in ("rows", "ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "device_ms") if kk in v}
                   for k, v in results.items()},
    }


def _table_row(kernel, launches, results, main, **extra):
    """The entry of a query kernel: its main-path shape's numbers."""
    extra = {"capacity": results[main]["capacity"], "library_ms": None,
             **extra}
    return _row(*KERNELS[kernel], launches.get(LAUNCH_NAME[kernel], 0),
                results, main, **extra)


def scan_kernel_phase(torch, dev, state, launches, flush):
    from repro_torch.core.engine import QueryEngine
    from repro_torch.exec import lower
    from repro_torch.exec.batch import bucket_capacity, from_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import filter_agg as fa
    from repro_torch.kernels import groupby_onehot as go
    from repro_torch.kernels import segmented_minmax as smm
    from repro_torch.kernels.program import eval_slot, for_columns
    from repro_torch.sql.queries import QUERIES

    plain = {"filter_agg": fa.fused_filter_agg_plain,
             "groupby_onehot": go.fused_groupby_plain,
             "segmented_minmax": smm.fused_groupby_minmax_plain}
    session, lineitem = state["session"], state["lineitem"]
    engine = QueryEngine(session.store, state["catalog"],
                         platform=session.platform, handler=session.handler)
    sqls = {"filter_agg": QUERIES["q6"], "groupby_onehot": QUERIES["q1"],
            "segmented_minmax": MINMAX_SQL}
    n_total = len(lineitem["l_orderkey"])
    table = []
    for kernel, sql in sqls.items():
        plan = engine.plan_sql(sql)
        m = next(lower.match_fragment(p.op) for p in plan.pipelines.values()
                 if p.kernel == kernel)
        prog, tiling = m.program, m.tiling
        wrapper = getattr(ops, KERNELS[kernel][0])
        names = list(prog.names)
        results = {}
        spec = _compiled_kernel(torch, dev, kernel, prog, lineitem)
        # each call: the program's kernel, then the finishing pass over
        # its partials
        expect = {f"spec_{spec['skeleton']}": 1, "reduce_partials_kernel": 1}
        for label, n in _sizes(n_total, state["rows"][kernel]):
            blk = from_numpy({c: lineitem[c][:n] for c in names},
                             bucket_capacity(n), dev)
            cols, mask = blk.columns, blk.mask

            def bound(got):
                # the mask over the capacity, the predicate's columns
                # over the valid rows, the other columns over the rows
                # that pass, the output once
                n_valid = int(mask.sum())
                typed = for_columns(prog, cols)
                n_pass = int((mask & (eval_slot(typed, 0, cols) != 0))
                             .sum()) if prog.has_pred else n_valid
                nbytes = _first_use_bytes(
                    [(prog.slot_columns(0), n_valid), (names, n_pass)],
                    lambda c, r: r * cols[c].element_size())
                return _bound(mask.numel() + nbytes + got.numel() * 8,
                              _program_work(prog, n_valid, n_pass))
            results[label] = _hold(
                torch, flush, f"{kernel} {label}",
                lambda: wrapper(cols, mask, program=prog, tiling=tiling),
                lambda: plain[kernel](cols, mask, program=prog),
                _compare, bound, dict(rows=n, capacity=mask.numel()),
                device=expect)
            del blk, cols, mask
        # the all-masked block and (for grouped kernels) empty groups
        n = 1 << 16
        blk = from_numpy({c: lineitem[c][:n] for c in names}, n, dev)
        cols = blk.columns
        none = torch.zeros(n, dtype=torch.bool, device=dev)
        _compare(wrapper(cols, none, program=prog, tiling=tiling),
                 plain[kernel](cols, none, program=prog),
                 f"{kernel} all-masked")
        if prog.n_groups:
            some = blk.mask & (cols[m.group_cols[0]] == 0)
            got = wrapper(cols, some, program=prog, tiling=tiling)
            if not bool((got[:, -1] == 0).any()):
                raise AssertionError(f"{kernel}: no empty group in the "
                                     "empty-group case")
            _compare(got, plain[kernel](cols, some, program=prog),
                     f"{kernel} empty groups")
        log(f"kernel {kernel}: all-masked"
            f"{' and empty-group' if prog.n_groups else ''} cases = plain")
        table.append(_table_row(kernel, launches, results, "main", **spec))
    return table


def _compiled_kernel(torch, dev, kernel, prog, lineitem):
    """The scan program's compiled kernel: compiled by NVRTC in the query
    phase's first call, a cache hit here. Fails if it compiles again or
    has local memory. Returns its row of the kernel table's extras."""
    from repro_torch.exec.batch import from_numpy
    from repro_torch.kernels import specialise
    from repro_torch.kernels.program import for_columns
    blk = from_numpy({c: lineitem[c][:1024] for c in prog.names}, 1024, dev)
    typed = for_columns(prog, blk.columns)
    before = len(specialise.loaded())
    k = specialise.kernel(typed, dev)
    hit = len(specialise.loaded()) == before
    made = (f"NVRTC {k.compile_ms:.1f} ms" if k.origin == "nvrtc"
            else "loaded from the disk cache")
    log(f"program {kernel}: {k.kind}, {made} at its first call (query "
        f"phase), second call {'a cache hit' if hit else 'compiled again'}"
        f", {k.regs} registers, {k.local_bytes} local bytes, {k.per_sm} "
        "CTAs an SM")
    if not hit:
        raise AssertionError(f"{kernel}: compiled again")
    if k.local_bytes:
        raise AssertionError(f"{kernel}: {k.local_bytes} B of local memory")
    return {"skeleton": k.kind, "compile_ms": k.compile_ms,
            "regs": k.regs, "local_bytes": k.local_bytes}


def _prepass(lower, xops, m, bcols, bmask):
    """The join arm's build-side prepass: build predicates, sort by key
    (masked rows last under the sentinel), payload gathered in order."""
    pred = lower._compile_pred(m.build_preds)
    if pred is not None:
        bmask = bmask & pred(bcols)
    sk, order = xops.sort_build_side(bcols, bmask, m.build_key)
    spay = {c: bcols[c][order] for c in m.payload if c in m.program.names}
    return sk, spay


def _join_variants(m, prog):
    """Programs of the same join beside the main path's split one: all
    predicates in slot 0 with no probe slot (the unsplit program: every
    valid row searched), a probe predicate that rejects every row, one
    that accepts every row (with all predicates in slot 0: the unsplit
    work through the probe slot) and, where the query has a residual,
    the residual alone."""
    from repro_torch.exec.operators import mixed_radix_strides
    from repro_torch.kernels.program import compile_program
    key = {"t": "col", "name": m.probe_key}
    zero = {"t": "lit", "value": 0, "kind": "num"}

    def variant(probe_preds, preds):
        return compile_program(
            preds, [(fn, arg) for _, fn, arg in m.aggs],
            group_cols=list(m.group_cols),
            strides=mixed_radix_strides(list(m.sizes)),
            n_groups=prog.n_groups, probe_preds=probe_preds)
    out = {"unsplit": variant(None, m.probe_preds + m.preds),
           # TPC-H keys are positive
           "rejects all": variant([{"t": "cmp", "op": "<", "l": key,
                                    "r": zero}], m.preds),
           "accepts all": variant([{"t": "cmp", "op": ">", "l": key,
                                    "r": zero}], m.probe_preds + m.preds)}
    if m.preds:
        out["residual only"] = variant([], m.preds)
    return out


def join_kernel_phase(torch, dev, state, launches, flush):
    import numpy as np
    from repro_torch.core.engine import QueryEngine
    from repro_torch.exec import lower
    from repro_torch.exec import operators as xops
    from repro_torch.exec.batch import bucket_capacity, from_numpy
    from repro_torch.kernels import join_probe as jp
    from repro_torch.kernels import ops
    from repro_torch.kernels.program import eval_slot, for_columns
    from repro_torch.sql.queries import QUERIES

    session, tables = state["session"], state["tables"]
    lineitem = tables["lineitem"]
    engine = QueryEngine(session.store, state["catalog"],
                         platform=session.platform, handler=session.handler)
    n_total = len(lineitem["l_orderkey"])
    sentinel = np.iinfo(np.int64).max
    kind = "join_probe_agg"
    results, prepass = {}, {}
    for q, build in (("q12", "orders"), ("q14", "part"), ("q19", "part")):
        plan = engine.plan_sql(QUERIES[q])
        m = next(lower.match_fragment(p.op) for p in plan.pipelines.values()
                 if p.kernel == kind)
        prog, tiling = m.program, m.tiling
        if not prog.has_probe_pred:
            raise AssertionError(f"{q}: the join program has no probe "
                                 "predicate")
        variants = _join_variants(m, prog)
        bnames = sorted({m.build_key} | {c for c in m.payload
                                         if c in prog.names})
        nb = len(tables[build][m.build_key])
        bblk = from_numpy({c: tables[build][c] for c in bnames},
                          bucket_capacity(nb), dev)
        sk, spay = _prepass(lower, xops, m, bblk.columns, bblk.mask)
        prepass[q] = _time_ms(torch, lambda: _prepass(
            lower, xops, m, bblk.columns, bblk.mask), flush)
        log(f"join prepass {q}: sort of {nb} build keys (capacity "
            f"{bblk.capacity}) + payload gather {prepass[q] * 1e3:.1f} us "
            f"(median of {REPS})")
        pnames = sorted({c for c in prog.names if c not in spay}
                        | {m.probe_key})

        def call(cols, mask, keys=sk, pay=spay, prog=prog):
            return ops.fused_join_probe_agg(cols, mask, keys, pay,
                                            probe_key=m.probe_key,
                                            program=prog, tiling=tiling)

        def plain(cols, mask, keys=sk, pay=spay, prog=prog):
            return jp.fused_join_probe_agg_plain(cols, mask, keys, pay,
                                                 probe_key=m.probe_key,
                                                 program=prog)
        for label, n in _sizes(n_total, state["join_rows"][q]):
            blk = from_numpy({c: lineitem[c][:n] for c in pnames},
                             bucket_capacity(n), dev)
            cols, mask = blk.columns, blk.mask
            pk = cols[m.probe_key]
            pos = torch.searchsorted(sk, pk).clamp(0, sk.numel() - 1)
            hit = (sk[pos] == pk) & mask & (pk != sentinel)
            jcols = dict(cols, **{c: v[pos] for c, v in spay.items()})

            def counts(vp):
                """Rows the kernel searches (valid, passing the probe
                predicate), their hits, and the hits passing slot 0."""
                typed = for_columns(vp, cols, spay)
                searched = mask
                if typed.has_probe_pred:
                    searched = mask & (eval_slot(
                        typed, typed.probe_slot, jcols) != 0)
                found = hit & searched
                passed = found & (eval_slot(typed, 0, jcols) != 0) \
                    if typed.has_pred else found
                return (int(searched.sum()), int(found.sum()),
                        int(passed.sum()))

            def bound(vp):
                # the mask over the capacity; the probe predicate's
                # columns over the valid rows, the probe key over the
                # searched rows, the residual's columns over their hits,
                # the other columns over the hits that pass it (a
                # payload column at most once a build row); one sorted
                # key a searched row, at most each once; the output.
                # Operations: the probe predicate on the valid rows, the
                # rest on the searched hits. The search's repeated L2
                # reads are not counted.
                n_valid = int(mask.sum())
                searched, found, passed = counts(vp)

                def nbytes_of(c, r):
                    if c in spay:
                        return min(r, nb) * spay[c].element_size()
                    return r * cols[c].element_size()
                probe = (vp.slot_columns(vp.probe_slot)
                         if vp.has_probe_pred else set())
                nbytes = mask.numel() + min(searched, sk.numel()) * 8 \
                    + _first_use_bytes(
                        [(probe, n_valid), ({m.probe_key}, searched),
                         (vp.slot_columns(0), found),
                         (set(vp.names), passed)], nbytes_of)
                return lambda got: _bound(nbytes + got.numel() * 8,
                                          _program_work(vp, found, passed,
                                                        n_valid))
            searched, found, _ = counts(prog)
            results[f"{q} {label}"] = _hold(
                torch, flush, f"{kind} {q} {label}",
                lambda: call(cols, mask), lambda: plain(cols, mask),
                _compare, bound(prog), dict(
                    rows=n, capacity=mask.numel(), build_rows=nb,
                    hits=int(hit.sum()), searched=searched,
                    searched_hits=found),
                device=JOIN_KERNELS)
            if label == "main":
                # the same rows through the other forms of the program
                for name, vp in variants.items():
                    searched, found, _ = counts(vp)
                    results[f"{q} main {name}"] = _hold(
                        torch, flush, f"{kind} {q} main {name}",
                        lambda vp=vp: call(cols, mask, prog=vp),
                        lambda vp=vp: plain(cols, mask, prog=vp),
                        _compare, bound(vp), dict(
                            rows=n, capacity=mask.numel(), build_rows=nb,
                            searched=searched, searched_hits=found),
                        device=JOIN_KERNELS)
            del blk, cols, mask, pk, pos, hit, jcols
        # edge cases: an all-masked probe block, probe keys equal to the
        # sentinel, a build side with every key masked (no hits)
        n = 1 << 16
        blk = from_numpy({c: lineitem[c][:n] for c in pnames}, n, dev)
        cols = blk.columns
        none = torch.zeros(n, dtype=torch.bool, device=dev)
        _compare(call(cols, none), plain(cols, none),
                 f"{kind} {q} all-masked")
        skey = dict(cols, **{m.probe_key: torch.full_like(
            cols[m.probe_key], sentinel)})
        _compare(call(skey, blk.mask), plain(skey, blk.mask),
                 f"{kind} {q} sentinel keys")
        nsk, npay = _prepass(lower, xops, m, bblk.columns,
                             torch.zeros_like(bblk.mask))
        got = call(cols, blk.mask, nsk, npay)
        if prog.n_groups and bool(got[:, -1].any()):
            raise AssertionError(f"{kind} {q}: hits on a masked build")
        _compare(got, plain(cols, blk.mask, nsk, npay),
                 f"{kind} {q} masked build")
        _sync(torch)
        log(f"kernel {kind} {q}: all-masked, sentinel-key and masked-build "
            f"cases = plain")
        del blk, bblk, sk, spay
    return _table_row(kind, launches, results, "q12 main",
                      prepass_ms=prepass)


def bloom_kernel_phase(torch, dev, state, launches, flush):
    import numpy as np
    from repro_torch.exec.batch import bucket_capacity, from_numpy
    from repro_torch.kernels import bloom, ops

    lineitem, orders = state["lineitem"], state["tables"]["orders"]
    n_total = len(lineitem["l_orderkey"])
    spec = state["bloom_spec"]
    key = spec["semijoin"]["key"][0]
    f = bloom.bloom_from_wire(spec["semijoin"])
    main_words = bloom.words_tensor(f["words"], dev)
    kind = "bloom_filter"

    def call(keys, mask, words=main_words, bits=f["bits"]):
        return ops.fused_bloom_filter(keys, mask, words=words, bits=bits,
                                      k=f["k"], tiling=None)

    def plain(keys, mask, words=main_words, bits=f["bits"]):
        return bloom.fused_bloom_filter_plain(keys, mask, words=words,
                                              bits=bits, k=f["k"])
    results = {}
    for label, n in _sizes(n_total, state["bloom_rows"]):
        blk = from_numpy({key: lineitem[key][:n]}, bucket_capacity(n), dev)
        keys, mask = blk.columns[key], blk.mask

        def bound(got):
            # bytes: mask and verdict over the capacity, the key over the
            # valid rows, the words once; operations: two fmix32 (5
            # each) and up to k word tests (6 each) per valid row, on
            # 32-bit integers
            n_valid = int(mask.sum())
            return _bound(mask.numel() + got.numel() * got.element_size()
                          + n_valid * keys.element_size()
                          + main_words.numel() * 4,
                          n_valid * (10 + 6 * f["k"]), INT32_OPS)
        results[label] = _hold(
            torch, flush, f"{kind} {label}", lambda: call(keys, mask),
            lambda: plain(keys, mask), _equal, bound,
            dict(rows=n, capacity=mask.numel(), bits=f["bits"]),
            device={"bloom_kernel": 1})
        if label == "main":
            _one_launch(torch, flush, f"{kind} main",
                        lambda: call(keys, mask), "bloom_kernel")
            # where the time goes: the same rows against empty filters
            # (every valid row reads one word and stops there), from one
            # that L1 holds to one past the main filter
            for bits in (1 << 10, 1 << 20, f["bits"], 1 << 22):
                empty = torch.zeros(bits // 32, dtype=torch.int32,
                                    device=dev)
                if bool(call(keys, mask, empty, bits).any()):
                    raise AssertionError(f"{kind}: hit in an empty filter")
                ms = _time_ms(torch, lambda: call(keys, mask, empty, bits),
                              flush)
                dms = sum(_device_ms(torch, lambda: call(keys, mask, empty,
                                                         bits),
                                     flush, {"bloom_kernel": 1}).values())
                log(f"kernel {kind} main, empty filter of {bits} bits "
                    f"({bits // 8} B): {ms * 1e3:.1f} us, device "
                    f"{dms * 1e3:.1f} us")
            # the second wave's share: valid rows whose first bit is set
            # (a probe with k = 1 tests the first position alone)
            n_valid = int(mask.sum())
            first = int((bloom.bloom_probe_plain(keys, main_words, f["bits"],
                                                 k=1) & mask).sum())
            hits = int(plain(keys, mask).sum())
            share = first / max(n_valid, 1)
            log(f"kernel {kind} main: {first} of {n_valid} valid rows "
                f"({100 * share:.2f}%) pass the first probe and go on to "
                f"the second wave; {hits} pass all {f['k']}")
        del blk, keys, mask
    # edge cases: negative keys and keys ≥ 2^32 (truncated mod 2^32), as
    # int64 and as int32, against filters of 2^10, 2^20, 2^21 and 2^22
    # bits; whole, a length that is no multiple of the vector path's
    # chunk (a random mask) and a view at storage offset 1 (the scalar
    # loop); an all-masked block
    base = lineitem[key][:1 << 20].astype(np.int64)
    q = base.size // 4
    odd = np.concatenate([-base[:q], base[:q] + (1 << 32),
                          base[:q] - (1 << 40), base[:base.size - 3 * q]
                          * 7919])
    ragged = odd.size - 3
    m_np = np.random.default_rng(0).random(odd.size) < 0.9
    masks = {"whole": (slice(None), np.ones(odd.size, bool)),
             f"{ragged} rows": (slice(0, ragged), m_np),
             "offset 1": (slice(1, None), m_np)}
    members = orders["o_orderkey"][::3].astype(np.uint32)
    for bits in (1 << 10, 1 << 20, 1 << 21, 1 << 22):
        words = bloom.bloom_build(members, bits)
        w = bloom.words_tensor(words, dev)
        hit = bloom.bloom_probe_np(odd.astype(np.uint32), words, bits)
        for dtype in (np.int64, np.int32):
            kt = torch.from_numpy(odd.astype(dtype)).to(dev)
            for label, (sl, m) in masks.items():
                keys, mask = kt[sl], torch.from_numpy(m).to(dev)[sl]
                ctx = f"{kind} {bits} bits {dtype.__name__} {label}"
                if bloom.vector_layout(keys.data_ptr(), keys.element_size(),
                                       mask.data_ptr(), 0, keys.numel())[0] \
                        == (label == "offset 1"):
                    raise AssertionError(f"{ctx}: wrong path")
                got = call(keys, mask, w, bits)
                _equal(got, plain(keys, mask, w, bits), ctx)
                if not np.array_equal(got.cpu().numpy(), hit[sl] & m[sl]):
                    raise AssertionError(f"{ctx}: != host probe")
    keys = torch.from_numpy(odd).to(dev)
    none = torch.zeros(odd.size, dtype=torch.bool, device=dev)
    _equal(call(keys, none), plain(keys, none), f"{kind} all-masked")
    log(f"kernel {kind}: negative and >= 2^32 keys, int64 and int32, at "
        f"2^10, 2^20, 2^21 and 2^22 bits, {odd.size} and {ragged} rows "
        f"and a view at offset 1 (the scalar loop) (= plain = host "
        f"probe), all-masked = plain")
    return _table_row(kind, launches, results, "main", bits=f["bits"],
                      first_probe_share=share)


# -- the sort kernels ---------------------------------------------------------

def _same(got, want, ctx, exact=True):
    """Lane for lane: integers, masks and (``exact``) floats bit for bit;
    else floats at rtol = atol = 1e-9 with NaN on the same lanes. Returns
    max |err| over the lanes finite in both."""
    import numpy as np
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"{ctx}: {g.dtype}{g.shape} != {w.dtype}"
                             f"{w.shape}")
    if g.dtype.kind != "f" or exact:
        gb = g.view(np.int64 if g.itemsize == 8 else np.int32) \
            if g.dtype.kind == "f" else g
        wb = w.view(gb.dtype) if g.dtype.kind == "f" else w
        if not np.array_equal(gb, wb):
            raise AssertionError(f"{ctx}: {int((gb != wb).sum())} lanes "
                                 f"differ")
        return 0.0
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True,
                               err_msg=ctx)
    finite = np.isfinite(g) & np.isfinite(w)
    return float(np.max(np.abs(g[finite] - w[finite]), initial=0.0))


def _compare_sort_agg(got, want, ctx):
    for j, (a, b) in enumerate(zip(got[0], want[0])):
        _same(a, b, f"{ctx} key {j}")
    _same(got[2], want[2], f"{ctx} mask")
    return max([_same(a, b, f"{ctx} total {j}", exact=False)
                for j, (a, b) in enumerate(zip(got[1], want[1]))] + [0.0])


def _compare_topk(got, want, ctx):
    if list(got[0]) != list(want[0]):
        raise AssertionError(f"{ctx}: columns {list(got[0])} != "
                             f"{list(want[0])}")
    _same(got[1], want[1], f"{ctx} mask")
    for c in want[0]:
        _same(got[0][c], want[0][c], f"{ctx} {c}")
    return 0.0


def _sort_ops(n, lanes):
    """A comparison sort's least work: n log2 n compares of every lane."""
    import math
    return n * max(math.log2(n), 1.0) * lanes


def _library_sort_ms(torch, flush, keys, mask):
    """The same permutation as the sort-aggregate's network from library
    calls: one stable torch.sort of the packed key inv << 62 | key where
    a single key lies in [0, 2^62) (as l_orderkey), else a stable sort a
    lane, last lane first, each lane gathered by the order so far (LSD),
    over ``[inv] + keys`` (Q3's join stage: three keys)."""
    if len(keys) == 1 and not bool((keys[0] >= 1 << 62).any()) \
            and not bool((keys[0] < 0).any()):
        packed = ((~mask).to(torch.int64) << 62) | keys[0]
        return _time_ms(torch, lambda: torch.sort(packed, stable=True),
                        flush)
    lanes = [(~mask).to(torch.int64)] + list(keys)

    def lsd():
        idx = torch.arange(mask.numel(), device=mask.device)
        for x in reversed(lanes):
            idx = idx[torch.sort(x[idx], stable=True).indices]
        return idx
    return _time_ms(torch, lsd, flush)


def _library_topk(torch, flush, cols, mask, sort_keys, limit, plain):
    """The top-k's selection from library calls. Row 6's one call, a
    stable ``torch.sort`` of a packed key, needs the invalid flag and each
    sort key's ordered bits (``sortnet.encode_key``), each less its
    minimum, to fit 63 bits; Q3's keys do not (a float64 revenue and a
    date), so the selection takes a stable sort a lane, last lane first,
    each lane gathered by the order so far (LSD), then the first
    ``limit`` rows, held against the plain version's. Returns (ms of the
    whole LSD, the packed key's bits, library calls)."""
    from repro_torch.kernels import sortnet
    lanes = [(~mask).to(torch.int64)] + [
        sortnet.encode_key(cols[k], d) for k, d in sort_keys]
    # unsigned order of the ordered bits is signed order with the sign
    # bit flipped
    signed = [lane ^ torch.iinfo(torch.int64).min for lane in lanes]
    bits = sum((int(x.max()) - int(x.min())).bit_length() for x in signed)

    def lsd():
        idx = torch.arange(mask.numel(), device=mask.device)
        for x in reversed(signed):
            idx = idx[torch.sort(x[idx], stable=True).indices]
        return idx
    order = lsd()
    ms = _time_ms(torch, lsd, flush)
    want_cols, want_mask = plain
    n = min(limit, int(mask.sum()))
    for c, v in want_cols.items():
        torch.testing.assert_close(cols[c][order[:n]], v[:n], rtol=0,
                                   atol=0, equal_nan=True,
                                   msg=f"topk library: column {c} differs")
    if int(want_mask.sum()) != n:
        raise AssertionError("topk library: row count differs")
    return ms, bits, 2 * len(lanes) + 1


def _radix_passes(torch, mask, keys, descending=None):
    """Live passes of the radix sort on these keys: the 8-bit digits of
    the encoded lanes (invalid flag first) not equal in every row."""
    from repro_torch.kernels import sortnet
    desc = descending or [False] * len(keys)
    lanes = [(~mask).long()] + [sortnet.encode_key(k, d)
                                for k, d in zip(keys, desc)]
    return len(sortnet.live_digits(lanes))


def _edge_key(np, rng, kind, n):
    """A key column for the radix sort's edges: all equal (no live
    digit), the int64 extremes, f64 with -0.0, NaN and ±inf, or ties."""
    if kind == "equal":
        return np.full(n, -3, np.int64)
    if kind == "extremes":
        return rng.choice(np.array([np.iinfo(np.int64).min,
                                    np.iinfo(np.int64).max, -1, 0, 1],
                                   np.int64), n)
    if kind == "f64":
        f = rng.normal(size=n).round(1)
        return np.where(rng.random(n) < 0.4, rng.choice(np.array(
            [-0.0, 0.0, np.nan, np.inf, -np.inf]), n), f)
    return rng.integers(-5, max(n // 4, 2), n).astype(np.int64)


def sort_kernel_phase(torch, dev, state, launches, flush):
    """``fused_sort_agg`` and ``fused_topk`` against their plain versions:
    at the main path's captured inputs (the GROUP BY l_orderkey fragment,
    Q3's join stage, Q3's final), at 2^20 rows, and on the edge cases."""
    import numpy as np
    from repro_torch.analysis import roofline
    from repro_torch.exec.batch import bucket_capacity, from_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sort_agg as sa
    from repro_torch.kernels import topk as tk

    lineitem = state["lineitem"]
    rng = np.random.default_rng(0)
    sentinel = np.iinfo(np.int64).max

    # -- sort_agg
    (keys, values, fns, mask), kw = state["sort_input"]
    tiling = kw["tiling"]
    if state["sf"] == 1 and mask.numel() != 1 << 23:
        raise AssertionError(f"sort_agg main fragment capacity "
                             f"{mask.numel()}, want 2^23")

    def sa_call(keys, values, fns, mask, tiling=tiling):
        return ops.fused_sort_agg(keys, values, fns, mask, tiling=tiling)

    def sa_bound(keys, values, fns, mask):
        def bound(got):
            # the mask, keys and argument values read once, the output
            # keys, totals and mask written once
            n = mask.numel()
            nbytes = 2 * n + 16 * n * len(keys) + 8 * n * (
                sum(1 for f in fns if f != "count") + len(fns))
            return _bound(nbytes, _sort_ops(n, 1 + len(keys)), INT32_OPS)
        return bound
    # the first 2^20 rows of lineitem
    n20 = min(1 << 20, len(lineitem["l_orderkey"]))
    blk = from_numpy({c: lineitem[c][:n20] for c in ("l_orderkey",
                                                       "l_quantity")},
                     bucket_capacity(n20), dev)
    key20 = [blk.columns["l_orderkey"].to(torch.int64)]
    qty = blk.columns["l_quantity"].to(torch.float64)
    val20 = [None if f == "count" else qty for f in fns]
    mask20 = blk.mask
    sa_results, library = {}, {}
    # Q3's join stage: its three keys (l_orderkey, o_orderdate,
    # o_shippriority) and its revenue, under the mask the joins leave
    (q3keys, q3values, q3fns, q3mask), q3kw = state["sort_q3_input"]
    if len(q3keys) != 3:
        raise AssertionError(f"sort_agg q3 join: {len(q3keys)} keys, want 3")
    for label, (k, v, f, m), til in (
            ("2^20", (key20, val20, fns, mask20), tiling),
            ("main", (keys, values, fns, mask), tiling),
            ("q3 join", (q3keys, q3values, q3fns, q3mask),
             q3kw["tiling"])):
        passes = _radix_passes(torch, m, k)
        log(f"kernel sort_agg {label}: {passes} live radix passes")
        sa_results[label] = _hold(
            torch, flush, f"sort_agg {label}",
            lambda: sa_call(k, v, f, m, til),
            lambda: sa.fused_sort_agg_plain(k, v, f, m),
            _compare_sort_agg, sa_bound(k, v, f, m),
            dict(rows=int(m.sum()), capacity=m.numel(),
                 groups=int(sa_call(k, v, f, m, til)[2].sum()),
                 radix_passes=passes))
        library[label] = _library_sort_ms(torch, flush, k, m)
        sa_results[label]["library_ms"] = library[label]
        log(f"kernel sort_agg {label}: library torch.sort(stable=True) of "
            f"the packed key, or a lane at a time, {library[label]} ms")
    # edge cases at 2^16 rows, every aggregate function
    n = 1 << 16
    base = np.resize(lineitem["l_orderkey"], n).astype(np.int64)
    x = rng.normal(size=n) * 100
    some = rng.random(n) < 0.8
    xnan = x.copy()
    xnan[~some & (rng.random(n) < 0.5)] = np.nan
    xnan[~some & (rng.random(n) < 0.5)] = np.inf
    kmax = base.copy()
    kmax[rng.random(n) < 0.01] = sentinel
    cases = {"all-masked": (base, x, np.zeros(n, bool)),
             "one group": (np.full(n, 7, np.int64), x, some),
             "every row its own group": (np.arange(n, dtype=np.int64), x,
                                         some),
             "valid INT64_MAX keys": (kmax, x, some),
             "NaN and inf in masked rows": (base, xnan, some)}
    all_fns = ["sum", "count", "min", "max"]
    for label, (k, v, m) in cases.items():
        kt = [torch.from_numpy(k).to(dev)]
        vt = torch.from_numpy(v).to(dev)
        mt = torch.from_numpy(m).to(dev)
        _compare_sort_agg(sa_call(kt, [vt, None, vt, vt], all_fns, mt),
                          sa.fused_sort_agg_plain(kt, [vt, None, vt, vt],
                                                  all_fns, mt),
                          f"sort_agg {label}")
    # the radix sort's edges: one row, one and two radix blocks (2^12,
    # 2^13 rows), no live pass, the int64 extremes, 3 key lanes
    for n, kinds in ((1, ["ties"]), (1 << 12, ["equal"]),
                     (1 << 12, ["extremes"]),
                     (1 << 13, ["ties", "extremes", "ties"]),
                     (1 << 13, ["equal", "equal"])):
        kt = [torch.from_numpy(_edge_key(np, rng, kd, n)).to(dev)
              for kd in kinds]
        vt = torch.from_numpy(rng.normal(size=n)).to(dev)
        mt = torch.from_numpy(rng.random(n) < 0.8).to(dev)
        label = f"{n} rows, keys {'/'.join(kinds)}"
        _compare_sort_agg(
            ops.fused_sort_agg(kt, [vt, None, vt, vt], all_fns, mt,
                               tiling=roofline.sort_tiling(
                                   "sort_agg", n_keys=len(kt))),
            sa.fused_sort_agg_plain(kt, [vt, None, vt, vt], all_fns, mt),
            f"sort_agg {label}")
        cases[label] = None
    _sync(torch)
    log(f"kernel sort_agg: {', '.join(cases)} = plain")
    rows = [_table_row("sort_agg", launches, sa_results, "main",
                       library_ms=library["main"],
                       library_call="torch.sort(stable=True) of the packed "
                                    "key inv << 62 | key: the sort only")]

    # -- topk
    (tcols, tmask), tkw = state["topk_input"]
    sort_keys, limit, ttiling = tkw["sort_keys"], tkw["limit"], tkw["tiling"]
    if state["sf"] == 1 and (tmask.numel() != 1 << 14 or tk.path(
            tmask.numel(), len(sort_keys)) != tk.CLUSTER):
        raise AssertionError(f"topk main: capacity {tmask.numel()}, want "
                             f"2^14 on the one-launch cluster path")

    def tk_call(cols, m, sk=sort_keys, lim=limit):
        return ops.fused_topk(cols, m, sort_keys=sk, limit=lim,
                              tiling=ttiling)

    def tk_plain(cols, m, sk=sort_keys, lim=limit):
        return tk.fused_topk_plain(cols, m, sort_keys=sk, limit=lim)

    def tk_bound(cols, m, sk=sort_keys):
        def bound(got):
            # the mask and every column read once and written once
            n = m.numel()
            width = sum(c.element_size() for c in cols.values())
            return _bound(2 * n + 2 * n * width,
                          _sort_ops(n, 1 + len(sk)), INT32_OPS)
        return bound
    # 2^20 random rows shaped as Q3's final input
    r20 = 1 << 20
    rand = {"rev": torch.from_numpy(rng.normal(size=r20) * 1e5).to(dev),
            "d": torch.from_numpy(rng.integers(8000, 10000, r20).astype(
                np.int32)).to(dev),
            "k": torch.from_numpy(rng.integers(0, 1 << 40, r20)).to(dev),
            "p": torch.from_numpy(np.zeros(r20, np.int32)).to(dev)}
    rmask = torch.from_numpy(rng.random(r20) < 0.9).to(dev)
    rkeys = [("rev", True), ("d", False)]
    # the CUDA kernels of one call on each path, by the profiler: the
    # cluster path launches one; the radix path a histogram and a scatter
    # per digit slot (dead ones return at once) and the gather
    tk_kernels = {tk.CLUSTER: {"topk_block_kernel": 1},
                  tk.RADIX: {"radix_scatter_kernel": 8 * len(rkeys) + 1,
                             "gather_kernel": 1}}
    tk_results = {}
    for label, (c, m, sk) in (("2^20", (rand, rmask, rkeys)),
                              ("main", (tcols, tmask, sort_keys))):
        passes = _radix_passes(torch, m, [c[k] for k, _ in sk],
                               [bool(d) for _, d in sk])
        how = tk.path(m.numel(), len(sk))
        log(f"kernel topk {label}: {how} path, {passes} live radix passes")
        if how == tk.CLUSTER:
            _one_launch(torch, flush, f"topk {label}",
                        lambda: tk_call(c, m, sk), "topk_block_kernel")
        tk_results[label] = _hold(
            torch, flush, f"topk {label}", lambda: tk_call(c, m, sk),
            lambda: tk_plain(c, m, sk), _compare_topk, tk_bound(c, m, sk),
            dict(rows=int(m.sum()), capacity=m.numel(), limit=limit,
                 sort_keys=[[k, bool(d)] for k, d in sk],
                 radix_passes=passes, path=how),
            device=tk_kernels[how])
        lib_ms, bits, calls = _library_topk(torch, flush, c, m, sk, limit,
                                            tk_plain(c, m, sk))
        if bits <= 63:
            raise AssertionError(f"topk {label}: the packed key fits "
                                 f"{bits} bits: time its one sort")
        library[f"topk {label}"] = lib_ms
        log(f"kernel topk {label}: library {lib_ms} ms: no one call, the "
            f"packed key needs {bits} bits; a stable torch.sort a lane "
            f"with gathers (LSD), {calls} calls")
    # edge cases on both sides of the cluster path's cap (2^14: one
    # launch; 2^15 and 2^16: the radix sort)
    tcases = {}
    for n in (1 << 14, 1 << 15, 1 << 16):
        sub = {c: v[:n].clone() for c, v in rand.items()}
        smask = rmask[:n].clone()
        ties = dict(sub, rev=torch.full((n,), 3.5, dtype=torch.float64,
                                        device=dev),
                    d=torch.full((n,), 9000, dtype=torch.int32, device=dev))
        zeros = dict(sub, rev=torch.where(
            torch.arange(n, device=dev) % 2 == 0, 0.0, -0.0).to(
                torch.float64))
        nan = dict(sub, k=torch.where(smask, sub["k"].double(),
                                      float("nan")))
        nan["k"][~smask & (torch.arange(n, device=dev) % 3 == 0)] = \
            float("inf")
        how = tk.path(n, len(rkeys))
        for label, (c, m, lim) in {
                "ties on every sort key": (ties, smask, 10),
                "-0.0 against +0.0 under desc": (zeros, smask, 100),
                "limit >= the valid rows": (sub, smask, n),
                "NaN and inf in masked rows": (nan, smask, 10),
                "all-masked": (sub, torch.zeros_like(smask), 10)}.items():
            lab = f"{n} rows ({how}), {label}"
            _compare_topk(tk_call(c, m, rkeys, lim),
                          tk_plain(c, m, rkeys, lim), f"topk {lab}")
            tcases[lab] = None
    # the sort's edges: f64 keys with -0.0, NaN and ±inf, ascending and
    # descending, over the int64 extremes and an all-equal key, at one
    # row, 2^12 and 2^13 rows (one launch) and 2^15 (the radix sort)
    for n in (1, 1 << 12, 1 << 13, 1 << 15):
        ec = {name: torch.from_numpy(_edge_key(np, rng, name, n)).to(dev)
              for name in ("f64", "extremes", "equal")}
        em = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        for sk in ([("f64", False)], [("f64", True)], [("equal", True)],
                   [("extremes", True), ("f64", False), ("equal", False)]):
            lab = f"{n} rows, keys {sk}"
            tiling = roofline.sort_tiling("topk", n_keys=len(sk))
            _compare_topk(ops.fused_topk(ec, em, sort_keys=sk, limit=7,
                                         tiling=tiling),
                          tk.fused_topk_plain(ec, em, sort_keys=sk, limit=7),
                          f"topk {lab}")
            tcases[lab] = None
    _sync(torch)
    log(f"kernel topk: {', '.join(tcases)} = plain")
    rows.append(_table_row(
        "topk", launches, tk_results, "main",
        library_lsd_ms=library["topk main"],
        library_call="none: the packed key (inv, encoded sort keys less "
                     "their minima) needs more than 63 bits; "
                     "library_lsd_ms: a stable torch.sort a lane (LSD), "
                     "then the first LIMIT rows"))
    return rows


# -- where the redesigned kernels' time goes ----------------------------------

def _profile(torch, label, fn, expect):
    """Device time of each CUDA kernel one call of ``fn`` launches
    (:func:`_kernel_times`: it fails unless each kernel of ``expect``
    launched), largest first."""
    rows = _kernel_times(torch, fn, expect)
    log(f"profile {label}: {sum(ms for ms, _ in rows.values()):.4f} ms of "
        f"device time in {sum(n for _, n in rows.values()):g} launches")
    for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.4f} ms  x{n:<3g} {key[:70]}")


def profile_phase(torch, dev, state):
    """Kernel by kernel, the main calls of the two redesigned kernels: the
    GROUP BY l_orderkey fragment's sort_agg (radix passes, then the
    segmented scan) and granite-3-2b's bf16 attention at S 4096."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    (keys, values, fns, mask), kw = state["sort_input"]
    _profile(torch, "sort_agg main", lambda: ops.fused_sort_agg(
        keys, values, fns, mask, **kw),
        {"radix_scatter_kernel": 1, "scan_apply_kernel": 1})
    g = get_config("granite-3-2b")
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (h, 4096, g.head_dim_), dtype=np.float32)).to(dev, torch.bfloat16)
        for h in (g.n_heads, g.n_kv_heads, g.n_kv_heads))
    _profile(torch, "flash_attention granite S4096 causal bf16",
             lambda: ops.flash_attention(q, k, v, causal=True),
             {"flash_wgmma_kernel": 1})


# -- the kernels no query reaches ---------------------------------------------

def _attn_pairs(S, causal, window):
    """(query, key) pairs a head's attention needs: key <= query under
    ``causal``, key > query - window under ``window``."""
    import numpy as np
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i + 1 if causal else np.full_like(i, S)
    return int(np.maximum(hi - lo, 0).sum())


def _flash_executed(S, causal, window, hd, bf16):
    """Operations a head's attention executes on the card: every 64-row
    query block computes each 64-key tile the reference's block skipping
    keeps (none wholly above the diagonal or before the window), at 6·hd
    a pair in the bf16 kernel (QKᵀ, then P split in two bf16 parts times
    V) and 4·hd in the float32 one."""
    nk = -(-S // 64)
    tiles = 0
    for q0 in range(0, S, 64):
        kb0 = max(0, q0 - window + 1) // 64 if window else 0
        kb1 = min(nk, min(q0 + 63, S - 1) // 64 + 1) if causal else nk
        tiles += kb1 - kb0
    return tiles * 64 * 64 * (6 if bf16 else 4) * hd


def _ssd_flops(b, S, H, P, N, Q):
    """Operations the SSD scan needs: per chunk of L real tokens, C·Bᵀ
    on its L(L+1)/2 causal pairs once per sequence (B and C are shared by
    the heads); per head the weighted pairs times x, the carried state
    into the outputs (not in the first chunk) and the state update (not
    after the last)."""
    flops, nc = 0, -(-S // Q)
    for c in range(nc):
        L = min(Q, S - c * Q)
        pairs = L * (L + 1) // 2
        flops += b * 2 * pairs * N
        flops += b * H * (2 * pairs * P + (c > 0) * 2 * L * N * P
                          + (c < nc - 1) * 2 * L * N * P)
    return flops


def _ssd_executed(b, S, H, P, N, Q, sms):
    """Operations the SSD kernel executes on the tensor cores: its
    products at the granularity it runs them (64-row strips, 64-key
    tiles, k-steps of 8; on the diagonal tile each 16-row warp stops at
    its last row), C·Bᵀ once per (batch, chunk, strip, head group), each
    product three times (the split TF32 operands)."""
    from repro_torch.kernels.ssd_scan import head_group

    def up8(v):
        return -(-v // 8) * 8
    nc, strips = -(-S // Q), -(-Q // 64)
    groups = -(-H // head_group(b, nc, strips, H, sms))
    flops = 0
    for c in range(nc):
        if c < nc - 1:                       # the chunk's own state
            flops += b * H * 2 * N * P * up8(Q)
        for st in range(strips):
            s0 = st * 64
            if c * Q + s0 >= S:
                continue
            tn = min(64, Q - s0)             # keys of the diagonal tile
            flops += b * groups * 2 * 64 * (s0 + 64) * N       # C·Bᵀ
            per_head = (s0 // 64) * 2 * 64 * 64 * P            # W·x
            per_head += sum(2 * 16 * P * up8(min(tn, wm + 16))
                            for wm in (0, 16, 32, 48))
            if c > 0:                        # C · state
                per_head += 2 * 64 * N * P
            flops += b * H * per_head
    return 3 * flops


def _close(tol):
    def compare(got, want, ctx):
        import numpy as np
        g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
        if g.shape != w.shape:
            raise AssertionError(f"{ctx}: shape {g.shape} != {w.shape}")
        np.testing.assert_allclose(g, w, **tol, err_msg=ctx)
        return float(np.max(np.abs(g - w), initial=0.0))
    return compare


def _close_bf16(exact):
    """bf16 attention at full width: the kernel's bf16 output against the
    plain version's float32 result on the same (bf16-valued) inputs,
    ``exact()``, within half a bf16 ulp (2^-8 of the value) plus 2e-5 of
    float32 summation slack; the reference's 2e-2 is as large as the
    outputs of late rows at these lengths and would pass a dropped key
    tile. Returns max |kernel - plain| against the bf16 plain output."""
    def compare(got, want, ctx):
        import numpy as np
        err = _close(dict(atol=2e-2, rtol=2e-2))(got, want, ctx)
        g, x = got.float().cpu().numpy(), exact().cpu().numpy()
        tight = float(np.max(np.abs(g - x)))
        log(f"{ctx}: max|kernel - float32 plain| {tight:.3g}, "
            f"max|kernel - bf16 plain| {err:.3g}")
        np.testing.assert_allclose(g, x, atol=2e-5, rtol=2.0 ** -8,
                                   err_msg=f"{ctx} against float32")
        return err
    return compare


def _close_to_max(got, want, ctx):
    """The reference's SSD tolerance: max |err| / max |ref| < 5e-5."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max()) + 1e-9
    log(f"{ctx}: max|err| / max|ref| {err / scale:.3g}")
    if got.shape != want.shape or not err / scale < 5e-5:
        raise AssertionError(f"{ctx}: max|err| {err:.3g} / max|ref| "
                             f"{scale:.3g} >= 5e-5")
    return err


def _close_q6(got, want, ctx):
    """Revenue at rtol 1e-4, the count exactly."""
    g, w = got.cpu().tolist(), want.cpu().tolist()
    if g[1] != w[1] or not abs(g[0] - w[0]) <= 1e-4 * abs(w[0]):
        raise AssertionError(f"{ctx}: {g} != {w}")
    return abs(g[0] - w[0])


def _case(kernel, label, call, plain, compare, bound, info, *,
          library=None, reps=REPS, device=None):
    return dict(kernel=kernel, label=label, call=call, plain=plain,
                compare=compare, bound=bound, info=info, library=library,
                reps=reps, device=device)


def _standalone_cases(torch, dev, state):
    """The shapes the slice drives (:func:`_case` each): inputs made from
    a numpy seed at the widths of the configured models, and the SF 1
    lineitem columns."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data.tpch import date_to_int
    from repro_torch.kernels import filter_agg as fa
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import groupby_onehot as go
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.config import SHAPES

    rng = np.random.default_rng(0)
    cases = []

    def normal(shape, dtype=torch.float32, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, dtype)

    # flash attention: (label, heads, kv heads, head dim, S, causal,
    # window, dtype); granite-3-2b and hymba-1.5b widths at train_4k's
    # and prefill_32k's lengths, then the edge cases
    granite, hymba = get_config("granite-3-2b"), get_config("hymba-1.5b")
    S4k, S32k = SHAPES["train_4k"].seq_len, SHAPES["prefill_32k"].seq_len
    g = (granite.n_heads, granite.n_kv_heads, granite.head_dim_)
    flash = [("granite S4096 causal bf16", *g, S4k, True, 0, torch.bfloat16),
             ("granite S4096 causal f32", *g, S4k, True, 0, torch.float32),
             ("granite S32768 causal bf16", *g, S32k, True, 0,
              torch.bfloat16),
             ("hymba S4096 window bf16", hymba.n_heads, hymba.n_kv_heads,
              hymba.head_dim_, S4k, True, hymba.sliding_window,
              torch.bfloat16),
             ("ragged S200 bf16", *g, 200, True, 0, torch.bfloat16),
             ("group 1 bf16", g[1], g[1], g[2], 1024, True, 0,
              torch.bfloat16),
             ("non-causal bf16", *g, 1024, False, 0, torch.bfloat16),
             # the tensor-core kernel's edges: head dim 128 (two TMA
             # boxes a row) ragged, windowed and non-causal, S below one
             # 64-key tile
             ("hd128 ragged S333 bf16", 8, 2, 128, 333, True, 0,
              torch.bfloat16),
             ("hd128 window 256 S1000 bf16", 4, 2, 128, 1000, True, 256,
              torch.bfloat16),
             ("hd128 non-causal S513 bf16", 4, 4, 128, 513, False, 0,
              torch.bfloat16),
             ("S40 below one tile bf16", *g, 40, True, 0, torch.bfloat16)]
    for label, H, Hkv, hd, S, causal, window, dtype in flash:
        q, k, v = normal((H, S, hd), dtype), normal((Hkv, S, hd), dtype), \
            normal((Hkv, S, hd), dtype)
        if dtype == torch.float32:
            compare = _close(dict(atol=2e-5, rtol=2e-5))
        else:
            compare = _close_bf16(
                lambda q=q, k=k, v=v, c=causal, w=window:
                    fl.flash_attention_plain(q.float(), k.float(),
                                             v.float(), causal=c, window=w))
        pairs = H * _attn_pairs(S, causal, window)
        nbytes = (2 * H + 2 * Hkv) * S * hd * q.element_size()
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        # SDPA: a yardstick, never in the port; a window as a boolean band
        # mask, built here and not timed
        mask = None
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) \
                & (i[None, :] > i[:, None] - window)

        def library(q=q, k=k, v=v, c=causal, mask=mask):
            return F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=mask,
                is_causal=c and mask is None, enable_gqa=True)
        cases.append(_case(
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal, w=window: ops.flash_attention(
                q, k, v, causal=c, window=w),
            lambda q=q, k=k, v=v, c=causal, w=window:
                fl.flash_attention_plain(q, k, v, causal=c, window=w),
            compare,
            lambda got, nb=nbytes, f=4 * hd * pairs, p=peak:
                _bound(nb, f, p),
            dict(rows=S, q=[H, S, hd], kv=[Hkv, S, hd], causal=causal,
                 window=window, dtype=str(dtype).split(".")[1],
                 needed_flop=4 * hd * pairs,
                 executed_flop=H * _flash_executed(
                     S, causal, window, hd, dtype == torch.bfloat16)),
            library=library, reps=10 if S >= S32k else REPS))

    # the SSD scan: mamba2-130m over 8 sequences of train_4k, hymba-1.5b's
    # mixer over one, and a ragged length, with the reference's test draw
    # (dt near 0.8, A near -1: nothing past ~20 tokens back counts); then
    # mamba2-130m's own dynamics (dt log-uniform in [1e-3, 0.1] as its
    # dt_bias gives, A in [-16, -1]), whose memory of tens to thousands
    # of tokens reaches the off-diagonal tiles and the carried state
    mamba = get_config("mamba2-130m")
    m = (mamba.n_ssm_heads, mamba.ssm_head_dim, mamba.ssm_state,
         mamba.ssm_chunk)
    ssds = [("mamba2 b8 S4096", 8, S4k, *m, False),
            ("hymba b1 S4096", 1, S4k, hymba.n_ssm_heads,
             hymba.ssm_head_dim, hymba.ssm_state, hymba.ssm_chunk, False),
            ("ragged S1000", 1, 1000, *m, False),
            ("mamba2 b8 S4096 mamba2 dt/A", 8, S4k, *m, True),
            # the chunk-parallel split's edges at mamba2's widths: one
            # chunk, chunk 1024 (four C·Bᵀ key blocks), S not a multiple
            # of the chunk, one head (b·H below any head group)
            ("one chunk b2 S200", 2, 200, *m, True),
            ("chunk 1024 b2 S4096", 2, S4k, *m[:3], 1024, True),
            ("chunk 1024 S3000", 1, 3000, *m[:3], 1024, False),
            ("b1 H1 S1000 N16", 1, 1000, 1, m[1], 16, m[3], False)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, b, S, H, P, N, Q, long_memory in ssds:
        x = normal((b, S, H, P), scale=0.5)
        if long_memory:
            dt = torch.from_numpy(np.exp(rng.uniform(
                np.log(1e-3), np.log(0.1), (b, S, H))).astype(
                    np.float32)).to(dev)
            A_log = torch.from_numpy(np.log(rng.uniform(1.0, 16.0, H))
                                     .astype(np.float32)).to(dev)
        else:
            dt = F.softplus(normal((b, S, H)))
            A_log = normal((H,), scale=0.3)
        B, C = normal((b, S, N), scale=0.5), normal((b, S, N), scale=0.5)
        nbytes = 4 * (2 * b * S * H * P + b * S * H + H + 2 * b * S * N)
        needed = _ssd_flops(b, S, H, P, N, min(Q, S))
        cases.append(_case(
            "ssd_scan", label,
            lambda a=(x, dt, A_log, B, C), Q=Q: ops.ssd_scan(*a, chunk=Q),
            lambda a=(x, dt, A_log, B, C), Q=Q: ssd.ssd_scan_plain(
                *a, chunk=Q),
            _close_to_max,
            lambda got, nb=nbytes, f=needed: _bound(nb, f, TF32_FLOPS),
            dict(rows=b * S, x=[b, S, H, P], N=N, chunk=Q,
                 draw="mamba2 dt/A" if long_memory else "unit",
                 needed_flop=needed,
                 executed_flop=_ssd_executed(b, S, H, P, N, min(Q, S),
                                             sms),
                 bound_cuda_cores_ms=_bound(nbytes, needed,
                                            FP32_FLOPS)[1]),
            # the three phases; the state pass only past one chunk
            device={"chunk_state_kernel": 1, "chunk_out_kernel": 1,
                    **({"state_pass_kernel": 1} if S > Q else {})}))

    # TPC-H Q6 over the SF 1 lineitem columns, at the reference's types
    li = state["lineitem"]
    n = len(li["l_orderkey"])
    ship = torch.from_numpy(li["l_shipdate"].astype(np.int32)).to(dev)
    disc, qty, price = (torch.from_numpy(li[c].astype(np.float32)).to(dev)
                        for c in ("l_discount", "l_quantity",
                                  "l_extendedprice"))
    q6 = dict(date_lo=date_to_int("1994-01-01"),
              date_hi=date_to_int("1995-01-01"), disc_lo=0.05,
              disc_hi=0.07, qty_hi=24.0)
    cols = (ship, disc, qty, price)
    cases.append(_case(
        "filter_agg", "Q6 SF1 lineitem",
        lambda: ops.filter_agg(*cols, **q6),
        lambda: fa.filter_agg_plain(*cols, **q6), _close_q6,
        # bytes: the predicate's three columns on every row, the price on
        # the rows that pass (the count), the (2,) result
        lambda got: _bound(_first_use_bytes(
            [(("ship", "disc", "qty"), n), (("price",), int(got[1]))],
            lambda c, rows: 4 * rows) + 8, 7 * n, FP32_FLOPS),
        dict(rows=n, **q6),
        # one launch: the last CTA folds the partials
        device={"q6_kernel": 1}))

    # grouped sums: Q1's group id (returnflag × linestatus, K = 6) and a
    # K = 120 id, over (quantity, price, discount, tax, 1)
    vals = torch.from_numpy(np.stack(
        [li[c].astype(np.float32) for c in ("l_quantity", "l_extendedprice",
                                            "l_discount", "l_tax")]
        + [np.ones(n, np.float32)], axis=1)).to(dev)
    q1_gid = (li["l_returnflag"] * 2 + li["l_linestatus"]).astype(np.int32)
    A = vals.shape[1]
    for label, gid_np, K in (("Q1 K6", q1_gid, 6),
                             ("K120", (li["l_partkey"] % 120).astype(
                                 np.int32), 120)):
        gid = torch.from_numpy(gid_np).to(dev)

        def library(gid=gid, K=K):   # every id is in range here
            return torch.zeros((K, A), dtype=torch.float32,
                               device=dev).index_add_(0, gid, vals)
        cases.append(_case(
            "groupby_onehot", label,
            lambda gid=gid, K=K: ops.groupby_onehot(gid, vals, n_groups=K),
            lambda gid=gid, K=K: go.groupby_onehot_plain(gid, vals,
                                                         n_groups=K),
            _close(dict(atol=1e-3, rtol=1e-4)),
            lambda got, K=K: _bound(4 * n + 4 * n * A + 4 * K * A, n * A,
                                    FP32_FLOPS),
            dict(rows=n, K=K, A=A, path=go.onehot_layout(K, A)[0]),
            library=library,
            device={("onehot_regs_kernel"
                     if go.onehot_layout(K, A)[0] == "registers"
                     else "onehot_warps_kernel"): 1, "fold_kernel": 1}))
    return cases


def _q6_edges(torch, dev, li, case, got, passes):
    """The fixed-layout Q6 kernel at its edges, each against the plain
    version (the count exact, the revenue within rtol 1e-4): 1, 3 and
    1,000,003 rows on the vector path (a ragged tail), the same as views
    at storage offset 1 (the scalar loop), each starting at a row that
    passes (``passes``, the predicate over the table), and the whole
    table at offset 1; and a second call at the main shape, which must
    give the same bits as ``got``."""
    import numpy as np
    from repro_torch.kernels import filter_agg as fa
    from repro_torch.kernels import ops

    b = {k: case["info"][k]
         for k in ("date_lo", "date_hi", "disc_lo", "disc_hi", "qty_hi")}
    again = case["call"]()
    if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"filter_agg Q6: a second call gave other "
                             f"bits, {again.tolist()} != {got.tolist()}")
    cols = [torch.from_numpy(li[c].astype(t)).to(dev) for c, t in (
        ("l_shipdate", np.int32), ("l_discount", np.float32),
        ("l_quantity", np.float32), ("l_extendedprice", np.float32))]
    rows = np.flatnonzero(passes)
    at = {0: int(rows[rows % 4 == 0][0]), 1: int(rows[rows % 4 == 1][0])}
    n = cols[0].numel()
    views = [(f"{m} rows{' offset 1' if off else ''}", at[off], m)
             for m in (1, 3, 1_000_003) for off in (0, 1)]
    views.append(("all rows offset 1", 1, n - 1))
    for label, start, m in views:
        v = [c[start:start + m] for c in cols]
        if fa.q6_layout([c.data_ptr() for c in v], m)[0] != (start % 4 == 0):
            raise AssertionError(f"filter_agg Q6 {label}: wrong path")
        _close_q6(ops.filter_agg(*v, **b), fa.filter_agg_plain(*v, **b),
                  f"filter_agg Q6 {label}")
    log(f"kernel filter_agg Q6: a second call gave the same bits; "
        f"{', '.join(lbl for lbl, _, _ in views)} = plain")


def standalone_kernel_phase(torch, ext, dev, state, flush):
    """The path of the kernels no query reaches: each wrapper of
    ``repro_torch.kernels.ops`` driven once at every shape of
    :func:`_standalone_cases`, with the launch counts reset just before
    and read just after; then each result held against the plain
    version and timed. Also checks Q6's revenue and match count against
    the query phase and numpy, Q1's group counts against numpy, and
    group ids out of range."""
    import numpy as np
    from repro_torch.data.tpch import date_to_int
    from repro_torch.kernels import groupby_onehot as go
    from repro_torch.kernels import ops

    # the plain versions' float32 products in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = _standalone_cases(torch, dev, state)
    ext.reset_launches()                     # the slice's path starts here
    outs = [case["call"]() for case in cases]
    _sync(torch)
    launches = ext.launches()                # ... and ends here
    log(f"launches on the standalone kernels' path: {launches}")
    for kernel, (_, _, counter) in STANDALONE.items():
        if launches.get(counter, 0) < 1:
            raise AssertionError(f"{kernel}: no launch on its path")
    by_label = {c["label"]: (c, o) for c, o in zip(cases, outs)}

    # Q6: the query phase's revenue, and the count of its predicate
    li = state["lineitem"]
    case, got = by_label["Q6 SF1 lineitem"]
    b = case["info"]
    m = ((li["l_shipdate"] >= b["date_lo"])
         & (li["l_shipdate"] < b["date_hi"])
         & (li["l_discount"] >= b["disc_lo"])
         & (li["l_discount"] <= b["disc_hi"])
         & (li["l_quantity"] < b["qty_hi"]))
    rev, cnt = got.cpu().tolist()
    want_rev = float(np.asarray(state["q6_rows"]["revenue"])[0])
    log(f"kernel filter_agg Q6: revenue {rev!r} (query Q6 {want_rev!r}), "
        f"count {cnt!r} (Q6's predicate on the float64 columns "
        f"{int(m.sum())})")
    if cnt != int(m.sum()) or not abs(rev - want_rev) <= 1e-4 * want_rev:
        raise AssertionError("filter_agg disagrees with Q6")
    _q6_edges(torch, dev, li, case, got, m)
    _one_launch(torch, flush, "filter_agg Q6", case["call"], "q6_kernel")
    # a yardstick of the card's read rate: one float32 torch.sum over as
    # many bytes as Q6's four columns hold (the flush buffer's first 16 B
    # a row, zeros)
    zeros = flush[:4 * case["info"]["rows"]].view(torch.float32)
    ms = _time_ms(torch, zeros.sum, flush)
    log(f"read yardstick: float32 torch.sum over {zeros.numel() * 4} B, "
        f"{ms * 1e3:.1f} us ({zeros.numel() * 4 / ms / 1e9:.3f} TB/s)")
    # Q1's group counts (the ones column) against numpy; Q1's filter as
    # gid -1, and gid = K, reach no group
    q1_gid = li["l_returnflag"] * 2 + li["l_linestatus"]
    _, got = by_label["Q1 K6"]
    if not np.array_equal(got[:, -1].cpu().numpy(),
                          np.bincount(q1_gid, minlength=6)):
        raise AssertionError(f"groupby_onehot Q1 counts {got[:, -1]}")
    # the register path (K·A <= 64) sums in a fixed order: a second call
    # gives the same bits
    case, _ = by_label["Q1 K6"]
    again = case["call"]()
    if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
        raise AssertionError("groupby_onehot Q1 K6: a second call gave "
                             "other bits")
    log(f"kernel groupby_onehot Q1 K6: {case['info']['path']} path, a "
        f"second call gave the same bits")
    kept = li["l_shipdate"] <= date_to_int("1998-09-02")
    filtered = torch.from_numpy(np.where(kept, q1_gid, -1).astype(
        np.int32)).to(dev)
    ones = torch.ones((len(filtered), 1), device=dev)
    for ids in (filtered, torch.full_like(filtered, 6)):
        got = ops.groupby_onehot(ids, ones, n_groups=6)
        _close(dict(atol=0, rtol=0))(
            got, go.groupby_onehot_plain(ids, ones, n_groups=6),
            "groupby_onehot out-of-range ids")
    if int(got.sum()) != 0:
        raise AssertionError("groupby_onehot: gid = K reached a group")
    log("kernel groupby_onehot: Q1 counts = numpy; ids -1 and K = plain")

    results = {k: {} for k in STANDALONE}
    for case in cases:
        info = case["info"]
        if "executed_flop" in info:
            log(f"kernel {case['kernel']} {case['label']}: executed "
                f"{info['executed_flop'] / 1e9:.3f} GFLOP against "
                f"{info['needed_flop'] / 1e9:.3f} needed "
                f"({info['executed_flop'] / info['needed_flop']:.3f}×)")
    for case, got in zip(cases, outs):
        results[case["kernel"]][case["label"]] = _hold(
            torch, flush, f"{case['kernel']} {case['label']}",
            case["call"], case["plain"], case["compare"], case["bound"],
            case["info"], got=got, reps=case["reps"],
            library=case["library"], device=case["device"])
    main = {"flash_attention": "granite S4096 causal bf16",
            "ssd_scan": "mamba2 b8 S4096", "filter_agg": "Q6 SF1 lineitem",
            "groupby_onehot": "Q1 K6"}
    return [_row(kernel, source, replaces, launches.get(counter, 0),
                 results[kernel], main[kernel])
            for kernel, (source, replaces, counter) in STANDALONE.items()]


# -- the exchange's partition: its path and its kernel ------------------------

# SF 10's fan-out (sql/physical.py's cap at that size) and the columns of
# Q3's lineitem exchange: the key first
PARTITION_DEST = 9
PARTITION_COLS = ("l_orderkey", "l_discount", "l_extendedprice",
                  "l_shipdate")


def _partition_host(dp, keys):
    """A partition's rows, meta, each destination's sorted candidates and
    sketches, on the host."""
    import numpy as np
    from repro_torch.exec import operators as tops
    from repro_torch.kernels import hash_partition as hp
    meta, cand = hp.download(dp)
    counts, kmv = hp.finish(dp, meta, cand, lambda a, b: tops.combine_hash(
        [dp.columns[k][a:b] for k in keys]).cpu().numpy().view(np.uint64))
    rows = int(counts.sum())
    n = dp.n_dest
    base, cand_n = meta[hp.MAX_DEST:hp.MAX_DEST + n], \
        meta[2 * hp.MAX_DEST:2 * hp.MAX_DEST + n]
    return {"cols": {c: t[:rows].cpu().numpy() for c, t in
                     dp.columns.items()}, "meta": meta,
            "cand": [np.sort(cand[b:b + k]) for b, k in zip(base, cand_n)],
            "kmv": kmv}


def _partition_equal(keys):
    """Bit for bit: every column's rows, the meta (counts, candidate
    offsets and counts, thresholds), each destination's candidates and
    sketch (max |err| 0)."""
    return lambda got, want, ctx: _partition_diff(got, want, ctx, keys)


def _partition_diff(got, want, ctx, keys):
    import numpy as np
    g, w = _partition_host(got, keys), _partition_host(want, keys)
    for c, v in w["cols"].items():
        if g["cols"][c].tobytes() != v.tobytes():
            raise AssertionError(f"{ctx}: column {c} differs")
    if not np.array_equal(g["meta"], w["meta"]) or g["kmv"] != w["kmv"] \
            or any(not np.array_equal(a, b)
                   for a, b in zip(g["cand"], w["cand"])):
        raise AssertionError(f"{ctx}: counts, candidates or sketches "
                             f"differ")
    return 0.0


def hash_partition_phase(torch, ext, dev, state, flush):
    """The exchange's partition kernel (``csrc/hash_partition.cu``). Its
    path: TPC-H Q3 through a session whose planner hashes both sides of
    every join into ``PARTITION_DEST`` partitions, the launch count set
    to 0 just before and read just after: one launch for each
    ``fragment.partition`` span that says ``kernel``, at least one, and
    the oracle's rows. Then the kernel against its plain version on the
    same card tensors, bit for bit, at an SF 10 Q3 lineitem producer's
    shape (2,000,000 valid of 2^21 rows of the lineitem's Q3 columns, 9
    destinations) and at 2^20 rows over 16 destinations, each timed
    beside its bound (least bytes: the mask, the keys of the valid rows
    once, their columns read and written once) with each CUDA kernel's
    device time. No single PyTorch call partitions rows by a hash
    (library: none)."""
    from repro_torch.api import connect
    from repro_torch.core import CoordinatorConfig
    from repro_torch.core.events import QueryObserver
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.sql.physical import PlannerConfig
    from repro_torch.sql.queries import QUERIES

    class Spans(QueryObserver):
        def __init__(self):
            self.spans = []

        def on_span(self, span):
            self.spans.append(span)

    rec = Spans()
    cfg = CoordinatorConfig(use_result_cache=False, planner=PlannerConfig(
        broadcast_threshold_bytes=1, exchange_partitions=PARTITION_DEST))
    with connect(state["session"].store, state["catalog"], quota=16,
                 device=dev, config=cfg, observers=(rec,)) as s:
        ext.reset_launches()                 # the kernel's path starts here
        t0 = time.perf_counter()
        res = s.submit(QUERIES["q3"]).result(timeout=900)
        wall = time.perf_counter() - t0
        launches = ext.launches().get(hp.NAME, 0)   # ... and ends here
        _assert_rows(res.fetch(s.store), state["truth"]["q3"], "q3-repart")
    where = [sp.attrs["where"] for sp in rec.spans
             if sp.name == "fragment.partition"]
    log(f"query q3-repart: wall {wall:.3f} s, {launches} hash_partition "
        f"launches, partitions {sorted(set(where))} x "
        f"{ {w: where.count(w) for w in sorted(set(where))} }, rows = oracle")
    if launches < 1 or launches != where.count("kernel"):
        raise AssertionError(f"hash_partition: {launches} launches for "
                             f"{where.count('kernel')} kernel partitions")
    for line in ext.build_log(hp.NAME).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas {hp.NAME}: {line.strip()}")

    li = state["lineitem"]
    results = {}
    for label, n, cap, n_dest, keys in (
            ("SF 10 Q3 producer", 2_000_000, 1 << 21, PARTITION_DEST,
             ["l_orderkey"]),
            ("2^20 x 16", 1 << 20, 1 << 20, 16,
             ["l_orderkey", "l_partkey"])):
        names = list(PARTITION_COLS) + [k for k in keys
                                        if k not in PARTITION_COLS]
        cols = {c: torch.from_numpy(li[c][:cap]).to(dev) for c in names}
        mask = torch.zeros(cap, dtype=torch.bool, device=dev)
        mask[:n] = True
        kt = [cols[k] for k in keys]

        def call(kt=kt, cols=cols, mask=mask, n_dest=n_dest):
            return hp.hash_partition_cuda(kt, cols, mask, n_dest)

        def plain(kt=kt, cols=cols, mask=mask, n_dest=n_dest):
            return hp.hash_partition_plain(kt, cols, mask, n_dest)

        def bound(got, cols=cols, keys=keys, cap=cap, n=n):
            nbytes = cap + n * (sum(cols[k].element_size() for k in keys)
                                + 2 * sum(t.element_size()
                                          for t in cols.values()))
            return _bound(nbytes, 0)

        results[label] = _hold(
            torch, flush, f"hash_partition {label}", call, plain,
            _partition_equal(keys), bound,
            {"rows": n, "capacity": cap, "n_dest": n_dest,
             "columns": len(cols), "keys": len(keys)},
            device={"count_kernel": 1, "scan_kernel": 1,
                    "scatter_kernel": 1})
    return _row(hp.NAME, "hash_partition.cu",
                "none: the reference partitions on the host "
                "(src/repro/exec/exchange.py)", launches, results,
                "SF 10 Q3 producer")


# -- model phase: the model stack's serving path -----------------------------

SERVE_ARCH = "granite-3-2b"       # the reference's serving default
SERVE_SHAPE = dict(batch=4, prompt_len=64, new_tokens=32)
MODEL_REL = 1e-4                  # card against the CPU port, of max |CPU|
SELF_REL = 2e-3                   # the reference's prefill / decode check


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return None if tree is None else tree.to(device)


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _rel_err(got, want, ctx, rel):
    """max |got - want| / max |want|, on the CPU; fails above ``rel``."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{ctx}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    r = err / max(scale, 1e-30)
    if not r <= rel:
        raise AssertionError(f"{ctx}: max|err| {err:.3g} / max|want| "
                             f"{scale:.3g} = {r:.3g} > {rel:g}")
    return r


def _timed(torch, fn):
    """(fn(), ms) between two CUDA events (the host clock without a
    card)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _device_busy(torch, fn, reps=3, warm=True, top=3):
    """(device ms, kernel launches, the ``top`` longest kernels) per call
    of ``fn``: every CUDA kernel, copy and fill the profiler records over
    ``reps`` calls (torch.profiler; elementwise kernels included), after
    one unprofiled call unless ``warm`` is false."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    _sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync(torch)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        rows.append((us / 1e3 / reps, ev.count / reps, ev.key[:60]))
    rows.sort(reverse=True)
    return (sum(r[0] for r in rows), sum(r[1] for r in rows), rows[:top])


def _serve_run(torch, cfg, params, tokens, frames, S, steps):
    """Forward over every token, then prefill of the first S and
    ``steps`` decode steps, all in float32: the tensors to compare."""
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.models.model import forward
    f32 = dict(compute_dtype=torch.float32)
    out = {"forward": forward(cfg, params, tokens, frames=frames, **f32)}
    out["prefill"], cache = prefill(cfg, params, tokens[:, :S],
                                    frames=frames, max_len=S + steps, **f32)
    out["cache0"] = cache
    for i in range(1, steps + 1):
        out[f"decode{i}"], cache = decode_step(
            cfg, params, cache, tokens[:, S + i - 1], **f32)
        out[f"cache{i}"] = cache
    return out


class _LayerFeed:
    """Teacher forcing of the model's layer loops (``model._layer_loop``,
    ``decode._loop``), to hold a deep model layer by layer: while
    ``recording``, each layer's input (its activations and cache slices)
    and output are kept; while replaying, each layer starts from the
    recorded input moved to ``dev``, and its output is kept beside the
    recorded one. Float32 summation order alone moves a deep model's
    free-running logits past 1e-4 of their largest value (PERF.md §6),
    so there each layer is held from the same input."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.inputs, self.outputs, self.card = [], [], []
        self.recording = True

    def __enter__(self):
        from repro_torch.models import decode, model
        self._saved = (model._layer_loop, decode._loop)
        model._layer_loop = lambda fn, x, stacked, n, remat=False: \
            self._loop(fn, x, stacked, n, has_cache=False)[0]
        decode._loop = self._loop
        return self

    def __exit__(self, *exc):
        from repro_torch.models import decode, model
        model._layer_loop, decode._loop = self._saved

    def _loop(self, layer, x, xs, n_layers, has_cache=True):
        from repro_torch.models.model import tree_index
        torch = self.torch
        outs_acc = []
        for i in range(n_layers):
            xs_i = tree_index(xs, i)
            cache = {k: v for k, v in xs_i.items() if k not in ("p", "pc")} \
                if has_cache else {}
            if self.recording:
                self.inputs.append((x, cache))
            else:
                x_in, c_in = self.inputs[len(self.card)]
                x = x_in.to(self.dev)
                if c_in:
                    xs_i = {**xs_i, **_tree_to(c_in, self.dev)}
            x, outs = layer(x, xs_i)
            (self.outputs if self.recording else self.card).append(x)
            outs_acc.append(outs)
        stacked = {k: torch.stack([o[k] for o in outs_acc])
                   for k in outs_acc[0]} if outs_acc and outs_acc[0] else {}
        return x, stacked


def _card_against_cpu(torch, dev, cfg, label, *, S, steps, batch=2, seed=0,
                      forced=False):
    """One set of parameters (drawn on the CPU from ``seed``) through
    :func:`_serve_run` on the CPU port and on the card: every logit and
    cache tensor within MODEL_REL of max |CPU value|. ``forced``: each
    layer on the card starts from the CPU's input to it
    (:class:`_LayerFeed`), and each layer's output is held too; the
    free-running error, and the CPU's own between two thread counts, are
    logged beside it. Returns the largest relative error held and the
    number of tensors held."""
    import contextlib
    import numpy as np
    from repro_torch.models.model import init_params
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, S + steps)).astype(np.int32))
    frames = (torch.from_numpy(rng.normal(
        0, 1, (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32))
        if cfg.enc_dec else None)
    card_args = (_tree_to(params, dev), tokens.to(dev),
                 _tree_to(frames, dev))
    feed = _LayerFeed(torch, dev) if forced else None
    with feed or contextlib.nullcontext():
        t0 = time.perf_counter()
        want = _serve_run(torch, cfg, params, tokens, frames, S, steps)
        t_cpu = time.perf_counter() - t0
        if feed:
            feed.recording = False
        t0 = time.perf_counter()
        got = _serve_run(torch, cfg, *card_args, S, steps)
        _sync(torch)
        t_card = time.perf_counter() - t0
    worst, n = 0.0, 0
    if feed:
        for i, (g, w) in enumerate(zip(feed.card, feed.outputs)):
            worst = max(worst, _rel_err(g, w, f"{label} layer call {i}",
                                        MODEL_REL))
        n += len(feed.outputs)
        if len(feed.card) != len(feed.outputs):
            raise AssertionError(f"{label}: {len(feed.card)} layer calls "
                                 f"on the card, {len(feed.outputs)} on "
                                 f"the CPU")
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            if sorted(g) != sorted(w):
                raise AssertionError(f"{label} {name}: keys {sorted(g)} "
                                     f"!= {sorted(w)}")
            for key, wv in w.items():
                if key == "pos":
                    if int(g[key]) != int(wv) or g[key].dtype != wv.dtype:
                        raise AssertionError(f"{label} {name} pos")
                    continue
                if g[key].dtype != wv.dtype:
                    raise AssertionError(f"{label} {name} {key}: dtype "
                                         f"{g[key].dtype} != {wv.dtype}")
                worst = max(worst, _rel_err(g[key], wv,
                                            f"{label} {name} {key}",
                                            MODEL_REL))
                n += 1
        else:
            worst = max(worst, _rel_err(g, w, f"{label} {name}", MODEL_REL))
            n += 1
    out = {"max_rel_err": worst, "tensors": n, "forced": forced}
    how = "each layer from the CPU's input to it, " if forced else ""
    log(f"model {label}: card = CPU port on {n} tensors ({how}forward, "
        f"prefill, {steps} decode step(s), caches), max|err|/max|CPU| "
        f"{worst:.3g} <= {MODEL_REL:g}; CPU {t_cpu:.2f} s, card "
        f"{t_card:.2f} s")
    if forced:
        # free running, for the record: the card's logits against the
        # CPU's, and the CPU's own at one thread against its default
        free = _serve_run(torch, cfg, *card_args, S, steps)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = _serve_run(torch, cfg, params, tokens, frames, S, steps)
        finally:
            torch.set_num_threads(threads)

        def spread(a):
            return max(float((a[k].float().cpu() - want[k]).abs().max())
                       / float(want[k].abs().max())
                       for k in want if not isinstance(want[k], dict))
        out["free_running_rel_err"] = spread(free)
        out["cpu_threads_rel_err"] = spread(one)
        log(f"model {label} free running (logits, not held): card against "
            f"CPU {out['free_running_rel_err']:.3g} of max|CPU|; the CPU "
            f"at 1 thread against {threads} threads "
            f"{out['cpu_threads_rel_err']:.3g}")
    return out


def model_phase(torch, ext, dev, smi):
    """The model stack's serving path on the card, in float32 with TF32
    off, the launch counts reset just before and read just after:
    (a) ``launch.serve.run_serving`` at granite-3-2b's full width and
    depth (batch 4, 64 prompt tokens, 32 new), its last prefill logits
    and first decode logits held against the card's own full forward on
    the same parameters (the reference's 2e-3 of max |logit|), timed
    beside the bounds a step reads and computes; (b) the card against
    the CPU port on one set of parameters: granite-3-2b at its published
    widths cut to 2 layers, and mamba2-130m whole; (c) every
    architecture's reduced config through prefill and one decode step
    on the card against the CPU port."""
    import dataclasses
    import statistics
    from repro_torch.configs import ARCHS, get_config, get_reduced
    from repro_torch.launch import serve
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.models.model import forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    ext.reset_launches()                     # the model path starts here
    on_card = dev.type == "cuda"
    if on_card:
        torch.empty(0, device=dev)           # the context, before its stats
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)

    # (a) full width and depth through the entry point
    trace: dict = {}
    out, stats = serve.run_serving(arch=SERVE_ARCH, reduced=False,
                                   device=dev, trace=trace, **SERVE_SHAPE)
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else 0
    cfg, params, prompts = trace["cfg"], trace["params"], trace["prompts"]
    B, P = prompts.shape
    f32 = dict(compute_dtype=torch.float32)
    full = forward(cfg, params, torch.cat([prompts, out[:, :1]], 1), **f32)
    scale = float(full[:, P - 1].abs().max())
    self_err = {}
    for name, got, at in (("prefill", trace["prefill_logits"], P - 1),
                          ("decode", trace["decode_logits"], P)):
        err = float((got - full[:, at]).abs().max()) / scale
        self_err[name] = err
        if not err < SELF_REL:
            raise AssertionError(f"model {SERVE_ARCH}: {name} logits "
                                 f"{err:.3g} of max|logit| from the full "
                                 f"forward (>= {SELF_REL:g})")
    if not torch.equal(out[:, 0], trace["prefill_logits"].argmax(-1).to(
            out.dtype)):
        raise AssertionError("model: first token is not the prefill argmax")
    # warm times: median of 5 prefills and of the 31 steps of a second
    # decode loop, each call alone between CUDA events
    new = SERVE_SHAPE["new_tokens"]
    ms_prefill, ms_step = [], []
    for _ in range(5):
        (logits, cache), ms = _timed(torch, lambda: prefill(
            cfg, params, prompts, max_len=P + new, **f32))
        ms_prefill.append(ms)
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(new - 1):
        (logits, cache), ms = _timed(torch, lambda: decode_step(
            cfg, params, cache, tok, **f32))
        tok = logits.argmax(-1).to(torch.int32)
        ms_step.append(ms)
    busy = {}
    if on_card:
        # the device's share of a warm step: kernel time against the
        # step's wall between events
        fixed = cache
        for name, fn, wall in (
                ("prefill", lambda: prefill(cfg, params, prompts,
                                            max_len=P + new, **f32),
                 statistics.median(ms_prefill)),
                ("decode", lambda: decode_step(cfg, params, fixed, tok,
                                               **f32),
                 statistics.median(ms_step))):
            dev_ms, kernels, top = _device_busy(torch, fn)
            busy[name] = {"device_ms": dev_ms, "launches": kernels,
                          "idle_share": 1.0 - dev_ms / wall}
            log(f"model (a) warm {name}: device busy {dev_ms:.3f} ms of "
                f"{wall:.3f} ms ({kernels:g} launches a call, idle share "
                f"{1.0 - dev_ms / wall:.3f}); longest: "
                + "; ".join(f"{k} {ms:.3f} ms x{n:g}" for ms, n, k in top))
    n_all, n_blocks = _numel(params), _numel(params["blocks"])
    bytes_all = 4 * n_all
    # a decode step reads every weight once; prefill's products are
    # 2 flops per block weight per token (the attention scores and the
    # last position's logits add under 1 %)
    decode_bound = 1e3 * max(bytes_all / HBM_BYTES_PER_S,
                             2 * n_all * B / FP32_FLOPS)
    prefill_bound = 1e3 * max(bytes_all / HBM_BYTES_PER_S,
                              2 * n_blocks * B * P / FP32_FLOPS)
    a = {"arch": SERVE_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
         **SERVE_SHAPE, "params": n_all, "block_params": n_blocks,
         "param_bytes": bytes_all,
         "prefill_ms": stats["prefill_s"] * 1e3,
         "decode_ms": stats["decode_s"] * 1e3,
         "decode_ms_per_step": stats["decode_s"] * 1e3 / (new - 1),
         "tokens_per_s": stats["tokens_per_s"],
         "warm_prefill_ms": statistics.median(ms_prefill),
         "warm_decode_ms_per_step": statistics.median(ms_step),
         "prefill_bound_ms": prefill_bound, "decode_bound_ms": decode_bound,
         "peak_mem_bytes": peak, "self_rel_err": self_err,
         "device_busy": busy}
    log(f"model (a) {SERVE_ARCH} full ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {n_all / 1e9:.3f} B parameters, "
        f"{bytes_all / 1e9:.2f} GB float32) through run_serving on {smi}: "
        f"prefill {a['prefill_ms']:.2f} ms (warm {a['warm_prefill_ms']:.3f}"
        f" ms; bound {prefill_bound:.3f} ms), decode {a['decode_ms']:.2f} "
        f"ms for {new - 1} steps, "
        f"{a['decode_ms_per_step']:.3f} ms a step (warm "
        f"{a['warm_decode_ms_per_step']:.3f}; bound {decode_bound:.3f} ms),"
        f" {a['tokens_per_s']:.1f} tok/s; peak memory {peak / 1e9:.2f} GB; "
        f"prefill / decode logits against the card's forward "
        f"{self_err['prefill']:.3g} / {self_err['decode']:.3g} of "
        f"max|logit| (< {SELF_REL:g})")
    del trace, params, full, logits, cache, out
    if on_card:
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev)
        log(f"model: after freeing, {left / 1e9:.3f} GB allocated")

    # (b) the card against the CPU port at published widths
    b = {"granite-3-2b x2 layers": _card_against_cpu(
            torch, dev, dataclasses.replace(get_config(SERVE_ARCH),
                                            n_layers=2),
            "granite-3-2b (2 of 40 layers)", S=32, steps=5),
         "mamba2-130m": _card_against_cpu(
            torch, dev, get_config("mamba2-130m"), "mamba2-130m (whole)",
            S=32, steps=5, forced=True)}
    # (c) every family at its reduced config
    c = {arch: _card_against_cpu(torch, dev, get_reduced(arch),
                                 f"{arch} reduced", S=48, steps=1)
         for arch in ARCHS}
    _sync(torch)
    launches = ext.launches()                # ... and ends here
    log(f"launches on the model path: {launches or 'none'} (the "
        f"reference's model path calls no kernel)")
    for name, n in sorted(launches.items()):
        log(f"  model path launched {name} x{n}")
    log(f"model phase: {time.perf_counter() - t_phase:.1f} s")
    return {"card": smi, "serve": a, "card_vs_cpu": b, "families": c,
            "launches": launches, "tf32": False}


# -- train phase: the training half of the model stack ------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_SHAPE = dict(batch=8, seq=128)   # the reference CLI's defaults
TRAIN_STEPS = 3
WARM_EXTRA = 3            # more warm steps timed after the three
TRAIN_LOSS_REL = 1e-6     # first step's loss against a no-grad forward
TRAIN_SELF_REL = 1e-5     # remat on / off, accum 2 / 1: of a leaf's max |g|
TRAIN_REL = 1e-5          # loss and grad_norm, card against the CPU port
GRAD_REL = 1e-4           # each gradient leaf, of its max |CPU value|
# mamba2 at 2 layers, free running: five times the CPU's own spread when
# its embeddings move by 1e-7 relative (1.6e-5 on grad_norm, 1.04e-4 of a
# leaf's max; this script's (b), on the CPU of the H100's host, PERF.md §6)
FREE_NORM_REL = 5 * 1.6e-5
FREE_GRAD_REL = 5 * 1.04e-4
CKPT_ARCH = "mamba2-130m"
CMP_SHAPE = dict(batch=2, seq=64)      # (b): the CPU side runs these
ADAMW_BYTES_PER_PARAM = 7 * 4          # read p, g, m, v; write p, m, v


def _leafwise(torch, got, want, names, ctx, rel):
    """The largest of each leaf's max |got - want| / max |want|; fails
    above ``rel``."""
    return max(_rel_err(g, w, f"{ctx} {n}", rel)
               for g, w, n in zip(got, want, names))


def _step_halves(torch, cfg, params, batch, opt):
    """One train step as ``make_train_step`` composes it, in its two
    halves so that the gradients can be kept: ``make_grad_fn``'s loss and
    gradients (float32, remat on), then the optimizer's in-place update
    from a fresh state. Returns (loss, grad_norm, gradients on the
    CPU)."""
    from repro_torch.models.steps import make_grad_fn
    loss, grads = make_grad_fn(cfg, compute_dtype=torch.float32)(params,
                                                                 batch)
    kept = [g.detach().cpu().clone() for g in grads]
    _, _, gnorm = opt.update_flat(grads, opt.init(params), params)
    return float(loss), float(gnorm), kept


def _layer_vjps(torch, cfg, params, batch):
    """The backward pass cut at the layers, on the CPU (the model's
    ``_layer_loop`` wrapped, remat off): each layer's input and the
    loss's gradient at its output, the first layer's input gradient
    (the embedding lookup's output gradient, under ``"dx"`` of the first
    record), and the last layer's output. Returns ``(records,
    x_last)``."""
    from repro_torch.models import model
    from repro_torch.models.steps import make_grad_fn
    records, last = [], []
    real = model._layer_loop

    def loop(fn, x, stacked, n, remat=False):
        for i in range(n):
            rec = {"x": x.detach()}
            if i == 0:
                x.register_hook(lambda g, r=rec: r.__setitem__(
                    "dx", g.detach()))
            x, _ = fn(x, model.tree_index(stacked, i))
            x.register_hook(lambda g, r=rec: r.__setitem__("dy",
                                                           g.detach()))
            records.append(rec)
        last.append(x.detach())
        return x
    model._layer_loop = loop
    try:
        make_grad_fn(cfg, remat=False, compute_dtype=torch.float32)(
            params, batch)
    finally:
        model._layer_loop = real
    return records, last[0]


def _forced_grads(torch, d, cfg, params, batch, records, x_last):
    """Each layer's VJP (its input's and its parameters' gradients) from
    the recorded input and output gradient, the embedding lookup's (the
    gather's backward into ``embed``) from the first layer's recorded
    input gradient, and the head's (final norm, logits, loss) from the
    recorded last output, on device ``d``: the gradients of the train
    step, each from the same inputs on both devices. Returns ``(names,
    tensors on the CPU)``."""
    from repro_torch.models import layers, model
    from repro_torch.models.steps import softmax_xent
    block = model.make_block_fn(cfg, causal=True)
    names, out = [], []

    def grads(y, leaves, gy=None):
        gs = torch.autograd.grad(y, leaves, grad_outputs=gy,
                                 allow_unused=True)
        return [torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, gs)]
    for i, rec in enumerate(records):
        x = rec["x"].to(d).requires_grad_(True)
        p = {k: v[i].detach().to(d).requires_grad_(True)
             for k, v in params["blocks"].items()}
        keys = sorted(p)
        y, _ = block(x, p)
        for k, g in zip(["x"] + keys, grads(y, [x] + [p[k] for k in keys],
                                            rec["dy"].to(d))):
            names.append(f"layer {i} {k}")
            out.append(g.cpu())
    embed = params["embed"].detach().to(d).requires_grad_(True)
    names.append("embed gather")
    out.append(grads(embed[batch["tokens"].to(d)], [embed],
                     records[0]["dx"].to(d))[0].cpu())
    head = {k: v.detach().to(d).requires_grad_(True)
            for k, v in params.items() if k != "blocks"}
    x = x_last.to(d).requires_grad_(True)
    h = layers.rms_norm(x, head["final_norm"], cfg.norm_eps)
    loss = softmax_xent(model.lm_logits(cfg, head, h, torch.float32),
                        batch["labels"].to(d))
    keys = sorted(head)
    for k, g in zip(["x"] + keys, grads(loss, [x] + [head[k]
                                                     for k in keys])):
        names.append(f"head {k}")
        out.append(g.cpu())
    return names, out


def _train_card_against_cpu(torch, dev, cfg, label, *, batch, seq, seed=0,
                            forced=False):
    """One train step from one set of parameters (drawn on the CPU from
    ``seed``) and ``synthetic_batch(cfg, 0, ...)`` on the CPU port and on
    the card: loss and grad_norm within TRAIN_REL relative, every
    gradient leaf within GRAD_REL of its max |CPU value|. ``forced``:
    the free-running gradient leaves and grad_norm are held only to
    FREE_GRAD_REL and FREE_NORM_REL, five times the CPU's own spread when
    its embeddings move by 1e-7 (measured again and logged), and the
    bars above hold each layer's VJP, the embedding lookup's and the
    head's, each from the CPU's recorded inputs to it
    (:func:`_forced_grads`), and the norm of their parameters' part
    (``vjp_param_norm_rel_err``), as ``model_phase`` holds a deep model's
    forward layer by layer."""
    from repro_torch.launch.train import make_trainer, synthetic_batch
    from repro_torch.models.model import init_params
    from repro_torch.tree import flatten_with_names, tree_map
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    names = [n for n, _ in flatten_with_names(params)]
    opt, _ = make_trainer(cfg, steps=TRAIN_STEPS)
    runs, secs = {}, {}
    for where in ("cpu", "card"):
        d = torch.device("cpu") if where == "cpu" else dev
        p = tree_map(lambda t: t.to(d, copy=True), params)
        t0 = time.perf_counter()
        runs[where] = _step_halves(
            torch, cfg, p, synthetic_batch(cfg, 0, batch, seq, d), opt)
        _sync(torch)
        secs[where] = time.perf_counter() - t0
        del p
    (lc, nc, gc), (lg, ng, gg) = runs["cpu"], runs["card"]
    out = {"loss_rel_err": abs(lg - lc) / abs(lc),
           "grad_norm_rel_err": abs(ng - nc) / abs(nc),
           "leaves": len(names), "loss": lc, "grad_norm": nc,
           "forced": forced}
    grad_bar, norm_bar = ((FREE_GRAD_REL, FREE_NORM_REL) if forced
                          else (GRAD_REL, TRAIN_REL))
    out["grad_max_rel_err"] = _leafwise(torch, gg, gc, names,
                                        f"train {label} grad", grad_bar)
    if forced:
        # the CPU against itself with the embeddings moved by 1e-7
        # relative: the conditioning the free-running bars come from
        moved = tree_map(lambda t: t.clone(), params)
        moved["embed"].mul_(1 + 1e-7 * torch.randn(
            moved["embed"].shape, generator=torch.Generator().manual_seed(1)))
        _, mn, mg = _step_halves(torch, cfg, moved, synthetic_batch(
            cfg, 0, batch, seq, "cpu"), opt)
        out["cpu_moved_1e-7_grad_rel_err"] = max(
            float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(mg, gc) if float(w.abs().max()) > 0)
        out["cpu_moved_1e-7_grad_norm_rel_err"] = abs(mn - nc) / abs(nc)
        b = synthetic_batch(cfg, 0, batch, seq, "cpu")
        records, x_last = _layer_vjps(torch, cfg, params, b)
        vn, want = _forced_grads(torch, torch.device("cpu"), cfg, params,
                                 b, records, x_last)
        _, got = _forced_grads(torch, dev, cfg, params, b, records, x_last)
        out["vjp_max_rel_err"] = _leafwise(torch, got, want, vn,
                                           f"train {label} VJP", GRAD_REL)
        out["vjps"] = len(vn)

        def norm(ts):       # the parameters' VJPs, not the activations'
            return float(torch.sqrt(sum(torch.sum(t.double() ** 2)
                                        for n, t in zip(vn, ts)
                                        if not n.endswith(" x"))))
        out["vjp_param_norm_rel_err"] = (abs(norm(got) - norm(want))
                                         / norm(want))
        if not out["vjp_param_norm_rel_err"] <= TRAIN_REL:
            raise AssertionError(
                f"train {label}: vjp_param_norm_rel_err "
                f"{out['vjp_param_norm_rel_err']:.3g} > {TRAIN_REL:g}")
        log(f"train {label}: {len(vn)} VJP tensors, each layer's, the "
            f"embedding lookup's and the head's from the CPU's input to it,"
            f" card = CPU within {out['vjp_max_rel_err']:.3g} of max|CPU| "
            f"(<= {GRAD_REL:g}), their parameters' norm "
            f"{out['vjp_param_norm_rel_err']:.3g} (<= {TRAIN_REL:g}); the "
            f"CPU against itself with the embeddings moved by 1e-7: "
            f"gradient leaves {out['cpu_moved_1e-7_grad_rel_err']:.3g}, "
            f"grad_norm {out['cpu_moved_1e-7_grad_norm_rel_err']:.3g}")
    for key, bar in (("loss_rel_err", TRAIN_REL),
                     ("grad_norm_rel_err", norm_bar)):
        if not out[key] <= bar:
            raise AssertionError(f"train {label}: {key} {out[key]:.3g} > "
                                 f"{bar:g}")
    log(f"train {label}: card = CPU port, loss {lg:.6f} / {lc:.6f} "
        f"({out['loss_rel_err']:.3g}), grad_norm {ng:.6g} / {nc:.6g} "
        f"({out['grad_norm_rel_err']:.3g} <= {norm_bar:g}), {len(names)} "
        f"gradient leaves max|err|/max|CPU| {out['grad_max_rel_err']:.3g} "
        f"<= {grad_bar:g}{' (free running)' * forced};"
        f" CPU {secs['cpu']:.2f} s, card {secs['card']:.2f} s")
    return out


def _train_full(torch, dev, smi, on_card):
    """(a): granite-3-2b whole, the trainer's own step (``make_trainer``,
    as ``run_training`` builds it), three steps of ``synthetic_batch``
    batches at batch 8 × 128 after the gradient checks, then WARM_EXTRA
    more timed steps (the warm time is the median of all but the first)
    and one under the profiler."""
    import gc
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_trainer, synthetic_batch
    from repro_torch.models.model import forward, init_params
    from repro_torch.models.steps import make_grad_fn, softmax_xent
    from repro_torch.tree import flatten_with_names
    f32 = dict(compute_dtype=torch.float32)
    cfg = get_config(TRAIN_ARCH)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)

    def peak():
        return (torch.cuda.max_memory_allocated(dev) - base) if on_card \
            else 0
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    names = [n for n, _ in flatten_with_names(params)]
    n_all = _numel(params)
    batches = [synthetic_batch(cfg, s, device=dev, **TRAIN_SHAPE)
               for s in range(TRAIN_STEPS + WARM_EXTRA + 1)]
    b0 = batches[0]
    with torch.no_grad():
        want = float(softmax_xent(forward(cfg, params, b0["tokens"], **f32),
                                  b0["labels"]))
    # before the optimizer state exists: remat on against off, and two
    # microbatches against one
    checks, grad_ms, grad_peak = {}, {}, {}
    (l_on, g_on), grad_ms["remat"] = _timed(
        torch, lambda: make_grad_fn(cfg, remat=True, **f32)(params, b0))
    grad_peak["remat"] = peak()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    (l_off, g_off), grad_ms["no_remat"] = _timed(
        torch, lambda: make_grad_fn(cfg, remat=False, **f32)(params, b0))
    grad_peak["no_remat"] = peak()
    checks["remat_vs_off"] = _leafwise(torch, g_off, g_on, names,
                                       "train (a) remat off", TRAIN_SELF_REL)
    del g_off
    (l_acc, g_acc), grad_ms["accum2"] = _timed(
        torch, lambda: make_grad_fn(cfg, accum_steps=2, **f32)(params, b0))
    checks["accum2_vs_1"] = _leafwise(torch, g_acc, g_on, names,
                                      "train (a) accum_steps=2",
                                      TRAIN_SELF_REL)
    del g_acc, g_on
    checks["loss_remat_vs_off"] = abs(float(l_on) - float(l_off)) / abs(want)
    checks["loss_accum2_vs_1"] = abs(float(l_acc) - float(l_on)) / abs(want)
    for key in ("loss_remat_vs_off", "loss_accum2_vs_1"):
        if not checks[key] <= TRAIN_SELF_REL:
            raise AssertionError(f"train (a) {key} {checks[key]:.3g}")
    # the trainer's three steps
    opt, step_fn = make_trainer(cfg, steps=TRAIN_STEPS)
    opt_state = opt.init(params)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    def allocs():
        st = torch.cuda.memory_stats(dev) if on_card else {}
        return [st.get(k, 0) for k in ("num_alloc_retries",
                                       "num_device_alloc",
                                       "num_device_free")]
    # the host's garbage collector, timed through its callbacks: a step
    # that builds and frees an autograd graph of about 13,000 nodes
    gc_log = []

    def on_gc(phase, info):
        if phase == "start":
            gc_log.append([info["generation"], time.perf_counter()])
        elif gc_log:
            gc_log[-1][1] = time.perf_counter() - gc_log[-1][1]
    losses, norms, step_ms, step_allocs, step_gc = [], [], [], [], []
    gc.callbacks.append(on_gc)
    try:
        for i in range(TRAIN_STEPS + WARM_EXTRA):
            before = allocs()
            gc_log.clear()
            (params, opt_state, m), ms = _timed(
                torch, lambda b=batches[i]: step_fn(params, opt_state, b))
            step_allocs.append([x - y for x, y in zip(allocs(), before)])
            step_gc.append([sum(1 for g, _ in gc_log if g == 2),
                            1e3 * sum(t for _, t in gc_log)])
            if i < TRAIN_STEPS:
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            step_ms.append(ms)
    finally:
        gc.callbacks.remove(on_gc)
    step_peak = peak()
    checks["first_loss_vs_forward"] = abs(losses[0] - want) / abs(want)
    if not checks["first_loss_vs_forward"] <= TRAIN_LOSS_REL:
        raise AssertionError(
            f"train (a): first step's loss {losses[0]!r} against the "
            f"no-grad forward's {want!r}: "
            f"{checks['first_loss_vs_forward']:.3g} > {TRAIN_LOSS_REL:g}")
    if not all(map(lambda v: v == v and abs(v) < 1e30, losses + norms)):
        raise AssertionError(f"train (a): losses {losses}, norms {norms}")
    warm = statistics.median(step_ms[1:])
    busy = {}
    if on_card:
        # a fourth step under the profiler: the device's share of a warm
        # step against the warm steps' median wall
        dev_ms, kernels, top = _device_busy(
            torch, lambda: step_fn(params, opt_state, batches[-1]),
            reps=1, warm=False, top=5)
        busy = {"device_ms": dev_ms, "launches": kernels,
                "idle_share": 1.0 - dev_ms / warm,
                "top": [[k, ms, n] for ms, n, k in top]}
        log(f"train (a) warm step: device busy {dev_ms:.3f} ms of "
            f"{warm:.3f} ms ({kernels:g} launches, idle share "
            f"{busy['idle_share']:.3f}); longest: "
            + "; ".join(f"{k} {ms:.3f} ms x{n:g}" for ms, n, k in top))
    tokens = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["seq"]
    flops_ms = 1e3 * 6 * n_all * tokens / FP32_FLOPS
    adamw_ms = 1e3 * ADAMW_BYTES_PER_PARAM * n_all / HBM_BYTES_PER_S
    a = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
         **TRAIN_SHAPE, "params": n_all, "remat": True, "steps": TRAIN_STEPS,
         "losses": losses, "grad_norms": norms, "step_ms": step_ms,
         "step_alloc_retries_mallocs_frees": step_allocs,
         "step_gc_gen2_collections_and_ms": step_gc,
         "warm_step_ms": warm, "bound_ms": flops_ms + adamw_ms,
         "bound_flops_ms": flops_ms, "bound_adamw_ms": adamw_ms,
         "grad_ms": grad_ms, "grad_peak_bytes": grad_peak,
         "peak_mem_bytes": step_peak, "checks": checks,
         "device_busy": busy}
    log(f"train (a) {TRAIN_ARCH} full ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {n_all / 1e9:.3f} B parameters) on {smi}, batch "
        f"{TRAIN_SHAPE['batch']} x {TRAIN_SHAPE['seq']}, float32, remat: "
        f"steps {', '.join(f'{ms:.3f}' for ms in step_ms)} ms (allocator "
        f"retries / cudaMalloc / cudaFree a step {step_allocs}; "
        f"generation-2 collections and all collection ms a step "
        f"{[[n, round(t, 1)] for n, t in step_gc]}; warm "
        f"{warm:.3f} ms, the median of steps 2-{len(step_ms)}; bound "
        f"{flops_ms + adamw_ms:.1f} ms = 6ND "
        f"{flops_ms:.1f} + AdamW {adamw_ms:.1f}); losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}; peak memory "
        f"{step_peak / 1e9:.2f} GB over the steps (gradients alone: remat "
        f"{grad_peak['remat'] / 1e9:.2f} GB, without "
        f"{grad_peak['no_remat'] / 1e9:.2f} GB; grad ms remat "
        f"{grad_ms['remat']:.1f}, without {grad_ms['no_remat']:.1f}, "
        f"accum 2 {grad_ms['accum2']:.1f}); first loss against the no-grad "
        f"forward {checks['first_loss_vs_forward']:.3g} (<= "
        f"{TRAIN_LOSS_REL:g}); gradients remat / off "
        f"{checks['remat_vs_off']:.3g}, accum 2 / 1 "
        f"{checks['accum2_vs_1']:.3g} of each leaf's max (<= "
        f"{TRAIN_SELF_REL:g})")
    return a


def _train_checkpoints(torch, dev):
    """(d): ``run_training`` at mamba2-130m whole: two steps a stage of
    one, failing at step 1 after the step-1 checkpoint, then resumed to
    step 2 on the same store; the step-2 checkpoint equals the resumed
    run's parameters bit for bit. Then the same drive at a reduced
    config against an uninterrupted run: the losses agree."""
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.specs import params_specs
    from repro_torch.launch.train import run_training
    from repro_torch.optim import AdamW
    from repro_torch.storage import ObjectStore, compression
    from repro_torch.tree import leaves
    run = dict(arch=CKPT_ARCH, reduced=False, steps=2, stage_steps=1,
               device=dev, **TRAIN_SHAPE)
    store, timings = ObjectStore(tier="local"), {"save": [], "restore": []}

    def timed(what, fn, state_of):
        # the trainer's own save and restore, timed to the device's end
        def call(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            _sync(torch)
            nbytes = sum(x.numel() * x.element_size()
                         for x in leaves(state_of(a, out)))
            timings[what].append({"s": time.perf_counter() - t,
                                  "bytes": nbytes})
            return out
        return call

    saved = train_mod.save_checkpoint, train_mod.load_checkpoint
    train_mod.save_checkpoint = timed("save", saved[0], lambda a, o: a[3])
    train_mod.load_checkpoint = timed("restore", saved[1],
                                      lambda a, o: o[0])
    t0 = time.perf_counter()
    try:
        try:
            run_training(store=store, run="smoke", fail_at_step=1, **run)
        except RuntimeError as e:
            if "injected failure at step 1" not in str(e):
                raise
        else:
            raise AssertionError("train (d): the injected failure did not "
                                 "hit")
        if latest_step(store, "smoke") != 1:
            raise AssertionError("train (d): no step-1 checkpoint")
        losses, params = run_training(store=store, run="smoke", **run)
    finally:
        train_mod.save_checkpoint, train_mod.load_checkpoint = saved
    if latest_step(store, "smoke") != 2 or len(losses) != 1 \
            or not abs(losses[0]) < float("inf"):
        raise AssertionError(f"train (d): resumed {losses}")
    cfg = get_config(CKPT_ARCH)
    template = {"params": params_specs(cfg)}
    template["opt"] = AdamW().init(template["params"])
    back, step = load_checkpoint(store, "smoke", template, step=2,
                                 device=dev)
    same = all(torch.equal(a, b) for a, b in zip(leaves(back["params"]),
                                                 leaves(params)))
    if step != 2 or not same:
        raise AssertionError("train (d): the step-2 checkpoint is not the "
                             "resumed run's parameters")
    stored = sum(len(store.get(k).data) for k in store.list("ckpt/smoke/"
                                                            "step00000002/"))
    d = {"arch": CKPT_ARCH, **TRAIN_SHAPE, "codec":
         compression.DEFAULT_CODEC, "resumed_loss": losses[0],
         "stored_bytes_step2": stored, "seconds": time.perf_counter() - t0}
    for what in ("save", "restore"):
        rows = timings[what]
        d[what] = [{"s": r["s"], "bytes": r["bytes"],
                    "mb_per_s": r["bytes"] / r["s"] / 1e6} for r in rows]
    log(f"train (d) {CKPT_ARCH} whole through run_training ({d['codec']}):"
        f" failed at step 1, resumed from the step-1 checkpoint, step-2 "
        f"checkpoint = the resumed parameters bit for bit; saves "
        + ", ".join(f"{r['s']:.2f} s ({r['mb_per_s']:.1f} MB/s)"
                    for r in d["save"])
        + "; restore " + ", ".join(f"{r['s']:.2f} s ({r['mb_per_s']:.1f} "
                                  f"MB/s)" for r in d["restore"])
        + f" of {d['save'][0]['bytes'] / 1e9:.3f} GB (stored "
        f"{stored / 1e9:.3f} GB); {d['seconds']:.1f} s")
    # the same fail-and-resume at a reduced config, against a whole run
    small = dict(arch="hymba-1.5b", reduced=True, steps=4, stage_steps=2,
                 batch=4, seq=32, device=dev, verbose=False)
    whole, _ = run_training(store=ObjectStore(tier="local"), **small)
    s2 = ObjectStore(tier="local")
    try:
        run_training(store=s2, fail_at_step=2, **small)
    except RuntimeError:
        pass
    rest, _ = run_training(store=s2, **small)
    err = max(abs(a - b) / abs(b) for a, b in zip(rest, whole[2:]))
    if len(rest) != 2 or not err <= TRAIN_LOSS_REL:
        raise AssertionError(f"train (d) reduced: resumed {rest} against "
                             f"{whole}")
    d["reduced_resume_rel_err"] = err
    log(f"train (d) hymba-1.5b reduced: fail at step 2 and resume = the "
        f"uninterrupted run's losses within {err:.3g} (<= "
        f"{TRAIN_LOSS_REL:g})")
    return d


def train_phase(torch, ext, dev, smi):
    """The model stack's training half on the card, in float32 with TF32
    off, the launch counts reset just before and read just after (the
    reference's training path calls no Pallas kernel, so none may
    launch): (a) granite-3-2b whole: the trainer's step (``launch/
    train.make_trainer``, remat on) over three batches of 8 × 128, timed
    by CUDA events beside its bound, peak memory, a fourth step's device
    busy time and idle share, after holding the gradients with remat
    against without and two microbatches against one, and the first
    loss against a no-grad forward; (b) the card against the CPU port on
    one train step: granite-3-2b and mamba2-130m at their published
    widths cut to 2 layers; (c) the ten reduced configs likewise; (d)
    ``launch/train.run_training`` at mamba2-130m whole, failing after
    its step-1 checkpoint and resumed to step 2 (save and restore
    seconds and MB/s), and a reduced fail-and-resume against an
    uninterrupted run."""
    import dataclasses
    from repro_torch.configs import ARCHS, get_config, get_reduced

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        torch.empty(0, device=dev)
        torch.cuda.empty_cache()
    ext.reset_launches()                     # the train path starts here
    a = _train_full(torch, dev, smi, on_card)
    if on_card:
        torch.cuda.empty_cache()
    # mamba2's random layers amplify a 1e-7 change of the embeddings to
    # 1e-4 of its largest gradients in two layers (PERF.md §6, PR 22):
    # held layer by layer, and free running to five times that spread
    b = {f"{arch} x2 layers": _train_card_against_cpu(
            torch, dev, dataclasses.replace(get_config(arch), n_layers=2),
            f"(b) {arch} (2 layers)", forced=arch == CKPT_ARCH,
            **CMP_SHAPE)
         for arch in (TRAIN_ARCH, CKPT_ARCH)}
    c = {arch: _train_card_against_cpu(torch, dev, get_reduced(arch),
                                       f"(c) {arch} reduced", batch=4,
                                       seq=32)
         for arch in ARCHS}
    d = _train_checkpoints(torch, dev)
    _sync(torch)
    launches = ext.launches()                # ... and ends here
    log(f"launches on the train path: {launches or 'none'} (the "
        f"reference's training path calls no kernel)")
    if launches:
        raise AssertionError(f"train path launched kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    log(f"train phase: {seconds:.1f} s")
    return {"card": smi, "full": a, "card_vs_cpu": b, "families": c,
            "checkpoint": d, "launches": launches, "tf32": False,
            "seconds": seconds}


# -- the dry run: every cell traced on meta, held against the card ------------

DRYRUN_MESHES = ["card", "16x16", "2x16x16"]
DRYRUN_WORKERS = 6          # processes tracing cells side by side
DRYRUN_BOUND_S = 10.0       # (c) runs the cells that fit with this bound


def _no_card() -> None:
    """A sweep worker: no card visible, so the trace cannot touch one."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _sweep_cell(arch, shape, meshes):
    """(records, seconds) of one (arch, shape) over ``meshes``, traced
    once, in a worker process that sees no card."""
    import torch
    from repro_torch.launch import dryrun
    if torch.cuda.is_available():
        raise AssertionError("a dry-run worker sees a card")
    t0 = time.perf_counter()
    records = dryrun.run([arch], [shape], meshes, emit=lambda line: None)
    return records, time.perf_counter() - t0


def _real_args(torch, dev, cfg, cell, seed=0):
    """A cell's arguments on ``dev``: seeded random parameters in the
    cell's dtype (``init_params`` with a generator on ``dev``), token ids
    below the vocab, encoder frames drawn normal, and every other leaf
    (AdamW's moments and step, the caches and their position) zero, as
    ``AdamW.init`` and ``init_cache`` make them."""
    from repro_torch import tree
    from repro_torch.models.model import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = tree.leaves(cell.arg_specs[0])[0].dtype
    params = init_params(cfg, gen, dtype)

    def leaf(name, t):
        if not t.dtype.is_floating_point and t.dim() > 0:
            return torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen,
                                 dtype=t.dtype, device=dev)
        if name.endswith("frames"):
            return torch.randn(tuple(t.shape), generator=gen, dtype=t.dtype,
                               device=dev)
        return torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev)
    rest = [tree.unflatten(a, [leaf(n, t) for n, t in
                               tree.flatten_with_names(a)])
            for a in cell.arg_specs[1:]]
    return (params, *rest)


def _dryrun_step(torch, dev, rec, trace):
    """(c) one real step of a cell on the card: the cell's step on seeded
    random arguments, once to warm up and once timed by CUDA events; its
    peak memory (the arguments included) beside the traced peak, and its
    outputs against the trace's shapes and dtypes, the logits finite."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import build_cell
    arch, shape = rec["arch"], rec["shape"]
    cfg = get_config(arch)
    cell = build_cell(cfg, arch, shape)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    args = _real_args(torch, dev, cfg, cell)
    with torch.no_grad():
        out = cell.step_fn(*args)             # warm-up
        _sync(torch)
        del out
        out, ms = _timed(torch, lambda: cell.step_fn(*args))
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else 0
    got, want = (tree.flatten_with_names(out),
                 tree.flatten_with_names(trace.outputs))
    if [(n, tuple(t.shape), t.dtype) for n, t in got] != \
            [(n, tuple(t.shape), t.dtype) for n, t in want]:
        raise AssertionError(f"dry run (c) {arch} {shape}: outputs differ "
                             f"from the trace's")
    logits = out[1] if cell.kind == "decode" else out[0]
    if cell.kind != "train" and not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"dry run (c) {arch} {shape}: logits not "
                             f"finite")
    del out, args
    r = rec["roofline"]
    bound_ms = max(r["compute_s"], r["memory_s"]) * 1e3
    row = {"arch": arch, "shape": shape, "kind": cell.kind,
           "traced_peak_bytes": rec["peak_bytes"],
           "measured_peak_bytes": peak,
           "measured_over_traced": peak / rec["peak_bytes"],
           "hbm_residency_bytes": rec["hbm_residency_bytes"],
           "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms}
    log(f"dry run (c) {arch} {shape}: peak traced "
        f"{rec['peak_bytes'] / 1e9:.3f} GB, measured {peak / 1e9:.3f} GB "
        f"(x{row['measured_over_traced']:.3f}), analytic residency "
        f"{rec['hbm_residency_bytes'] / 1e9:.3f} GB; step {ms:.3f} ms "
        f"against max(compute, memory) {bound_ms:.4f} ms")
    return row


def dryrun_phase(torch, ext, dev, smi, session, *, sf=1,
                 workers=DRYRUN_WORKERS, archs=None, shapes=None, out=None):
    """``repro_torch.launch.dryrun`` on the card's machine, the launch
    counts reset just before and read just after (none may launch): (a)
    every TPC-H query planned through ``session`` (the query phase's, at
    SF ``sf``) with no worker invoked; (b) every (arch × shape) traced at full
    width on ``meta`` over the card, 16×16 and 2×16×16 meshes, each
    (arch, shape) once, in ``workers`` processes that see no card, no
    cell in error and the card's allocated memory unchanged; (c) each
    cell whose traced peak fits the card and whose bound is at most
    ``DRYRUN_BOUND_S`` runs one real step on the card: its peak memory
    against the traced one, its time against the bound. ``out``: a path
    to write every record to, one JSON object a line."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.config import SHAPES

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    ext.reset_launches()                     # the dry run starts here
    invoked = session.platform.invocations
    t0 = time.perf_counter()
    failures = dryrun.dryrun_queries(sf=sf, session=session)
    plans_s = time.perf_counter() - t0
    if failures or session.platform.invocations != invoked:
        raise AssertionError(f"dry run (a): {failures} plans failed, "
                             f"{session.platform.invocations - invoked} "
                             f"invocations")
    if ext.launches():
        raise AssertionError(f"dry run (a) launched {ext.launches()}")

    # (b) the sweep, in processes that see no card
    allocated = torch.cuda.memory_allocated(dev) if on_card else 0
    cells = [(a, s) for a in (archs or ARCHS) for s in (shapes or SHAPES)]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx,
                             initializer=_no_card) as pool:
        done = [pool.submit(_sweep_cell, a, s, DRYRUN_MESHES)
                for a, s in cells]
        results = [f.result() for f in done]
    sweep_s = time.perf_counter() - t0
    records = [r for recs, _ in results for r in recs]
    for rec in records:
        log("dry run (b) " + dryrun.summary(
            f"{rec['arch']} × {rec['shape']} × {rec['mesh']}", rec))
    cell_s = {f"{a} {s}": sec for (a, s), (_, sec) in zip(cells, results)}
    log(f"dry run (b) seconds a cell: {json.dumps(cell_s)}")
    errors = [r for r in records if r["status"] == "error"]
    if errors:
        raise AssertionError(f"dry run (b): {len(errors)} cells in error: "
                             f"{[(r['arch'], r['shape'], r['mesh'], r['error']) for r in errors]}")
    if on_card and torch.cuda.memory_allocated(dev) != allocated:
        raise AssertionError("dry run (b) allocated memory on the card")
    log(f"dry run (b): {len(records)} records, "
        f"{sum(r['status'] == 'ok' for r in records)} ok, "
        f"{sum(r['status'] == 'skip' for r in records)} skip, in "
        f"{sweep_s:.1f} s ({workers} processes); slowest "
        f"{max(cell_s, key=cell_s.get)} {max(cell_s.values()):.1f} s")

    # (c) the cells that fit the card, one real step each
    card = [r for r in records if r["mesh"] == "card" and r["status"] == "ok"]
    run = [r for r in card if r["fits_card"] and max(
        r["roofline"]["compute_s"], r["roofline"]["memory_s"])
        <= DRYRUN_BOUND_S]
    steps = []
    for rec in run:
        cell = build_cell(get_config(rec["arch"]), rec["arch"], rec["shape"])
        steps.append(_dryrun_step(torch, dev, rec, dryrun.trace_cell(cell)))
    _sync(torch)
    launches = ext.launches()                # ... and ends here
    if launches:
        raise AssertionError(f"dry run launched kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    log(f"dry run phase: {seconds:.1f} s")
    if out is not None:
        with open(out, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    cells = {}
    for r in records:
        c = cells.setdefault(f"{r['arch']} {r['shape']}",
                             {"status": r["status"]})
        if r["status"] != "ok":
            continue
        roof = r["roofline"]
        if r["mesh"] == "card":
            c.update(trace_s=r["trace_s"], peak_bytes=r["peak_bytes"],
                     fits_card=r["fits_card"], fits_hbm=r["fits_hbm"],
                     compute_s=roof["compute_s"], memory_s=roof["memory_s"])
        else:
            c[r["mesh"]] = {"dominant": roof["dominant"],
                            "collective_s": roof["collective_s"],
                            "roofline_fraction": r["roofline_fraction"]}
    return {"card": smi, "plans": {"failures": failures, "seconds": plans_s},
            "sweep_seconds": sweep_s, "workers": workers, "cells": cells,
            "steps": steps, "launches": launches, "seconds": seconds}


# -- the mesh phase: the model stack over a DeviceMesh ------------------------

MESH_REL = 1e-5             # serving logits of max |logit|; loss, grad_norm
MESH_LEAF_REL = 1e-4        # each updated leaf, of its max
MESH_CARDS = 4              # the 2×2 (data, model) mesh over cards
MESH_ILL = 100              # (d): |clipped gradient| under this · eps
MESH_LR1 = 3e-4             # the trainer's rate at step 1


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dtensor_leaves(tree_) -> bool:
    from repro_torch import tree
    from torch.distributed.tensor import DTensor
    return all(isinstance(t, DTensor) for t in tree.leaves(tree_))


def _mesh_serve(torch, cfg, params, prompts, new, mesh, frames=None):
    """Prefill, then ``new - 1`` decode steps fed the tokens ``prompts``
    continue with (``prompts`` holds them past its prompt length ``P``),
    float32: each step's logits (plain tensors) and the final cache. On
    a mesh, ``params`` are DTensors and each step's tokens are laid out
    as a batch."""
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.parallel import sharding as sh
    P = prompts.shape[1] - (new - 1)

    def batch(t):
        if mesh is None or t is None:
            return t
        plan = sh.make_plan(mesh)
        return sh.shard_tree(plan, {"t": t}, sh.batch_shardings(
            plan, {"t": t}))["t"]
    f32 = dict(compute_dtype=torch.float32, mesh=mesh)
    logits, cache = prefill(cfg, params, batch(prompts[:, :P]),
                            frames=batch(frames), max_len=P + new, **f32)
    out = [sh.gather_tree(logits)]
    for i in range(new - 1):
        logits, cache = decode_step(cfg, params, cache,
                                    batch(prompts[:, P + i]), **f32)
        out.append(sh.gather_tree(logits))
    return out, cache


def _mesh_train(torch, cfg, params, batch, mesh, steps=1):
    """``steps`` trainer steps (remat, float32) from ``params``: the first
    step's loss and grad_norm, its updated parameters (whole, on the
    host), the last step's ms between CUDA events and the step's state."""
    from repro_torch import tree
    from repro_torch.launch.train import make_trainer
    from repro_torch.models.steps import make_train_step
    from repro_torch.parallel import sharding as sh
    opt, _ = make_trainer(cfg, steps=5)
    step = make_train_step(cfg, opt, compute_dtype=torch.float32, mesh=mesh)
    state = opt.init(params)
    if mesh is not None:
        plan = sh.make_plan(mesh)
        batch = sh.shard_tree(plan, batch, sh.batch_shardings(plan, batch))
    first, ms = None, None
    for i in range(steps):
        (params, state, m), ms = _timed(
            torch, lambda: step(params, state, batch))
        if i == 0:
            # a copy: the next step updates the parameters in place, and
            # a replicated leaf's whole value is its local tensor
            first = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": tree.tree_map(
                         lambda t: t.detach().to("cpu", copy=True),
                         sh.gather_tree(params))}
    return first, ms, params, state


def _hold_step(torch, got, want, ctx, ill=None):
    """A mesh step's first loss, grad_norm and updated leaves against the
    unsharded step's. ``ill``: per leaf, the elements whose first AdamW
    update is ill-conditioned in their gradient (``_ill_elements``), held
    to twice the step's rate instead."""
    from repro_torch import tree
    for k in ("loss", "grad_norm"):
        r = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
        if not r <= MESH_REL:
            raise AssertionError(f"{ctx}: {k} {got[k]} vs {want[k]} ({r:.3g}"
                                 f" > {MESH_REL:g})")
    worst = 0.0
    for i, ((name, a), b) in enumerate(zip(
            tree.flatten_with_names(got["params"]),
            tree.leaves(want["params"]))):
        if ill is not None:
            m = ill[i]
            if m.any() and float((a[m] - b[m]).abs().max()) > 2 * MESH_LR1:
                raise AssertionError(f"{ctx} {name}: an ill-conditioned "
                                     f"element moved past 2·lr")
            a, b = a.masked_fill(m, 0), b.masked_fill(m, 0)
        worst = max(worst, _rel_err(a, b, f"{ctx} {name}", MESH_LEAF_REL))
    return worst


def _ill_elements(torch, cfg, params, batch):
    """Per leaf (on the host), the elements whose clipped gradient is
    nonzero and under ``MESH_ILL`` · eps: AdamW's first step moves them
    by ``lr · ĝ / (|ĝ| + eps)``, which the last bits of the gradient
    (any other summation order) move by up to ``2 · lr``."""
    from repro_torch.launch.train import make_trainer
    from repro_torch.models.steps import make_grad_fn
    opt, _ = make_trainer(cfg, steps=5)
    _, grads = make_grad_fn(cfg, compute_dtype=torch.float32)(params, batch)
    norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    scale = min(1.0, opt.clip_norm / (norm + 1e-9))
    return [((g.abs() * scale < MESH_ILL * opt.eps) & (g != 0)).cpu()
            for g in grads]


def _mesh_reduced(torch, dev, mesh, arch):
    """One reduced config on the mesh against the port without one on
    the card: a train step (4 × 32), prefill (4 × 32) and two decode
    steps."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as sh
    cfg = get_reduced(arch)
    plan = sh.make_plan(mesh)

    def fresh():
        return init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    batch = synthetic_batch(cfg, 0, 4, 32, device=dev)
    want, _, _, _ = _mesh_train(torch, cfg, fresh(), batch, None)
    p = fresh()
    got, _, dp, state = _mesh_train(
        torch, cfg, sh.shard_tree(plan, p, sh.param_shardings(plan, p)),
        batch, mesh)
    if not (_dtensor_leaves(dp) and _dtensor_leaves(state)):
        raise AssertionError(f"mesh (c) {arch}: a leaf is not a DTensor")
    leaf = _hold_step(torch, got, want, f"mesh (c) {arch} train")
    del dp, state
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 34)).astype(np.int32)).to(dev)
    frames = batch.get("frames")
    p = fresh()
    want_s, _ = _mesh_serve(torch, cfg, p, tokens, 3, None, frames)
    got_s, cache = _mesh_serve(
        torch, cfg, sh.shard_tree(plan, p, sh.param_shardings(plan, p)),
        tokens, 3, mesh, frames)
    if not _dtensor_leaves(cache):
        raise AssertionError(f"mesh (c) {arch}: a cache leaf is not a "
                             f"DTensor")
    serve = max(_rel_err(g, w, f"mesh (c) {arch} serve step {i}",
                         MESH_LEAF_REL)
                for i, (g, w) in enumerate(zip(got_s, want_s)))
    log(f"mesh (c) {arch} reduced: train loss {got['loss']:.6f} "
        f"grad_norm {got['grad_norm']:.6f}, leaves {leaf:.3g} of max; "
        f"prefill and 2 decode steps' logits {serve:.3g} of max (bars "
        f"{MESH_REL:g} / {MESH_LEAF_REL:g})")
    return {"train_leaf_rel": leaf, "serve_rel": serve}


def _mesh_checkpoint(torch, dev, mesh, arch=SERVE_ARCH):
    """(e), and (d) on each rank: a checkpoint round trip of a sharded
    state. One mesh train step at ``arch`` reduced (the trainer's
    optimizer, 4 × 32), its DTensor state saved (every rank saves its
    own shards, ``save_checkpoint`` gathering leaf by leaf), restored,
    laid out by ``shard_tree`` with the run's specs, and step 2 from
    there against step 2 of the run that never stopped: loss, grad_norm
    and every leaf bit for bit. The saved objects equal the save of
    ``gather_tree(state)`` byte for byte; save and restore seconds and
    MB/s beside that unsharded tree's save and restore."""
    from repro_torch import tree
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import make_trainer, synthetic_batch
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.parallel import sharding as sh
    from repro_torch.storage import ObjectStore, compression
    cfg = get_reduced(arch)
    plan = sh.make_plan(mesh)
    opt, _ = make_trainer(cfg, steps=5)
    step = make_train_step(cfg, opt, compute_dtype=torch.float32, mesh=mesh)
    p = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    p_specs = sh.param_shardings(plan, p)
    dp = sh.shard_tree(plan, p, p_specs)
    st = opt.init(dp)
    specs = {"params": p_specs, "opt": sh.opt_state_shardings(plan, p, st)}
    b1, b2 = (sh.shard_tree(plan, b, sh.batch_shardings(plan, b))
              for b in (synthetic_batch(cfg, i, 4, 32, device=dev)
                        for i in (0, 1)))
    dp, st, _ = step(dp, st, b1)
    state = {"params": dp, "opt": st}

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        _sync(torch)
        return out, time.perf_counter() - t

    def objects(store):
        return {k: store.get(k).data for k in store.list("")}
    stores = {k: ObjectStore(tier="local") for k in ("mesh", "warm",
                                                     "plain")}
    # the first save also plans each leaf's gather (DTensor, on the host)
    _, save_s = timed(lambda: save_checkpoint(stores["mesh"], "smoke", 1,
                                              state))
    _, warm_save_s = timed(lambda: save_checkpoint(stores["warm"], "smoke",
                                                   1, state))
    whole = sh.gather_tree(state)
    _, plain_save_s = timed(lambda: save_checkpoint(stores["plain"], "smoke",
                                                    1, whole))
    saved = objects(stores["mesh"])
    if not saved == objects(stores["warm"]) == objects(stores["plain"]):
        raise AssertionError("mesh (e): the sharded state's objects are not "
                             "the gathered state's")
    (back, at), restore_s = timed(lambda: load_checkpoint(
        stores["mesh"], "smoke", state, device=dev))
    _, plain_restore_s = timed(lambda: load_checkpoint(
        stores["plain"], "smoke", whole, device=dev))
    resumed = sh.shard_tree(plan, back, specs)
    wrong = [n for (n, t), spec in zip(tree.flatten_with_names(resumed),
                                       tree.leaves(specs))
             if tuple(t.placements) != sh.placements(plan, spec)]
    if at != 1 or wrong:
        raise AssertionError(f"mesh (e): restored step {at}, leaves out of "
                             f"their placements: {wrong}")
    p_r, st_r, m_r = step(resumed["params"], resumed["opt"], b2)
    p_u, st_u, m_u = step(dp, st, b2)
    got = sh.gather_tree({"params": p_r, "opt": st_r})
    want = sh.gather_tree({"params": p_u, "opt": st_u})
    differ = [n for (n, a), b in zip(tree.flatten_with_names(got),
                                     tree.leaves(want))
              if not torch.equal(a, b)]
    for k in ("loss", "grad_norm"):
        if float(m_r[k]) != float(m_u[k]):
            differ.append(k)
    if differ:
        raise AssertionError(f"mesh (e): step 2 after the restore differs "
                             f"from the uninterrupted step 2 in {differ}")
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(whole))
    e = {"arch": arch, "reduced": True, "codec": compression.DEFAULT_CODEC,
         "leaves": len(tree.leaves(whole)), "bytes": nbytes,
         "stored_bytes": sum(map(len, saved.values())),
         "save_s": save_s, "warm_save_s": warm_save_s,
         "restore_s": restore_s, "plain_save_s": plain_save_s,
         "plain_restore_s": plain_restore_s,
         "loss2": float(m_r["loss"]), "grad_norm2": float(m_r["grad_norm"])}
    for k in ("save", "warm_save", "restore", "plain_save", "plain_restore"):
        e[f"{k}_mb_per_s"] = nbytes / e[f"{k}_s"] / 1e6
    return e


def _serve_tokens(torch, dev, cfg):
    """The serving shape's prompts and the tokens the decode steps are
    fed (random, as ``run_serving``'s prompts are)."""
    import numpy as np
    B, P, new = (SERVE_SHAPE[k] for k in ("batch", "prompt_len",
                                          "new_tokens"))
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P + new - 1)).astype(np.int32)).to(dev)


def mesh_phase(torch, ext, dev, smi, *, arch=SERVE_ARCH, reduced=False):
    """The model stack over a ``torch.distributed`` ``DeviceMesh``, in
    float32 with TF32 off, the launch counts reset just before and read
    just after (the model path launches no kernel): a process group of
    one rank over NCCL in this process and the one-card (data 1, model
    1) mesh, where every parameter, optimizer-state and cache leaf is a
    DTensor. (a) granite-3-2b whole served on the mesh (batch 4, 64
    prompt tokens, 31 decode steps fed the same tokens) against the port
    without a mesh on the card, each step's logits within ``MESH_REL``
    of their largest; (b) one full-width train step (8 × 128, the
    trainer's, remat) on the mesh against the unsharded step from the
    same initial tree, run first and freed: loss and grad_norm within
    ``MESH_REL``, each updated leaf within ``MESH_LEAF_REL`` of its
    largest; warm ms (the second step of each) and peak memory of both;
    (c) the ten reduced configs' train step, prefill and two decode
    steps on the mesh against the port without one; (d) with four cards
    or more, granite-3-2b whole on the 2×2 (data, model) mesh of four
    processes, one a card, against (a) and (b), and (e)'s round trip on
    that mesh; (e) a checkpoint round trip of a sharded state at
    granite-3-2b reduced (``_mesh_checkpoint``): save, restore,
    ``shard_tree`` and step 2 = the uninterrupted step 2 bit for bit, the
    objects = the gathered state's byte for byte, save and restore
    seconds beside the gathered tree's. ``arch`` / ``reduced`` replace
    (a)'s and (b)'s model in a rehearsal without a card."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, get_config, get_reduced
    from repro_torch.launch.mesh import card_mesh, device_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as sh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    # a fact of the machine, taken before any step runs
    cards = torch.cuda.device_count() if on_card else 0
    ext.reset_launches()                     # the mesh path starts here
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = device_mesh(card_mesh(), dev.type)
        plan = sh.make_plan(mesh)
        cfg = get_reduced(arch) if reduced else get_config(arch)

        def fresh():
            return init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)

        def peak_from():
            if not on_card:
                return lambda: 0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            return lambda: torch.cuda.max_memory_allocated(dev) - base

        # (a) serving, the port without a mesh first
        new = SERVE_SHAPE["new_tokens"]
        tokens = _serve_tokens(torch, dev, cfg)
        params = fresh()
        peak = peak_from()
        want, _ = _mesh_serve(torch, cfg, params, tokens, new, None)
        _, plain_ms = _timed(torch, lambda: _mesh_serve(
            torch, cfg, params, tokens, new, None))
        plain_peak = peak()
        dparams = sh.shard_tree(plan, params, sh.param_shardings(plan,
                                                                 params))
        peak = peak_from()
        got, cache = _mesh_serve(torch, cfg, dparams, tokens, new, mesh)
        if not (_dtensor_leaves(dparams) and _dtensor_leaves(cache)):
            raise AssertionError("mesh (a): a parameter or cache leaf is "
                                 "not a DTensor")
        _, mesh_ms = _timed(torch, lambda: _mesh_serve(
            torch, cfg, dparams, tokens, new, mesh))
        mesh_peak = peak()
        serve_err = [_rel_err(g, w, f"mesh (a) step {i}", MESH_REL)
                     for i, (g, w) in enumerate(zip(got, want))]
        a = {"arch": arch, "layers": cfg.n_layers, **SERVE_SHAPE,
             "plain_ms": plain_ms, "mesh_ms": mesh_ms,
             "plain_peak_bytes": plain_peak, "mesh_peak_bytes": mesh_peak,
             "max_rel_err": max(serve_err)}
        log(f"mesh (a) {arch} ({cfg.n_layers} layers) served on the "
            f"{dict(card_mesh().shape)} DeviceMesh on {smi}: prefill + "
            f"{new - 1} decode steps warm {mesh_ms:.1f} ms (without a "
            f"mesh {plain_ms:.1f} ms); peak {mesh_peak / 1e9:.2f} GB "
            f"({plain_peak / 1e9:.2f} GB); logits of {new} steps within "
            f"{max(serve_err):.3g} of max (bar {MESH_REL:g})")
        del params, dparams, cache, got

        # (b) one train step at full width, the unsharded one first
        batch = synthetic_batch(cfg, 0, TRAIN_SHAPE["batch"],
                                TRAIN_SHAPE["seq"], device=dev)
        # each peak counts from the parameters in place, as in (a)
        p = fresh()
        peak = peak_from()
        want_t, plain_ms_t, p, st = _mesh_train(torch, cfg, p, batch, None,
                                                steps=2)
        plain_peak_t = peak()
        del p, st
        p = fresh()
        p = sh.shard_tree(plan, p, sh.param_shardings(plan, p))
        peak = peak_from()
        got_t, mesh_ms_t, p, st = _mesh_train(torch, cfg, p, batch, mesh,
                                              steps=2)
        mesh_peak_t = peak()
        if not (_dtensor_leaves(p) and _dtensor_leaves(st)):
            raise AssertionError("mesh (b): a parameter or optimizer-state "
                                 "leaf is not a DTensor")
        del p, st
        leaf = _hold_step(torch, got_t, want_t, f"mesh (b) {arch}")
        b = {"arch": arch, **TRAIN_SHAPE, "loss": got_t["loss"],
             "grad_norm": got_t["grad_norm"], "plain_loss": want_t["loss"],
             "plain_grad_norm": want_t["grad_norm"],
             "max_leaf_rel_err": leaf, "plain_ms": plain_ms_t,
             "mesh_ms": mesh_ms_t, "plain_peak_bytes": plain_peak_t,
             "mesh_peak_bytes": mesh_peak_t}
        log(f"mesh (b) {arch} train step {TRAIN_SHAPE['batch']} x "
            f"{TRAIN_SHAPE['seq']} on the mesh on {smi}: warm "
            f"{mesh_ms_t:.1f} ms (without a mesh {plain_ms_t:.1f} ms); "
            f"peak {mesh_peak_t / 1e9:.2f} GB ({plain_peak_t / 1e9:.2f} "
            f"GB); loss {got_t['loss']:.6f} ({want_t['loss']:.6f}), "
            f"grad_norm {got_t['grad_norm']:.6f} "
            f"({want_t['grad_norm']:.6f}), leaves within {leaf:.3g} of "
            f"max")
        del want_t, got_t

        # (c) the reduced configs
        t0 = time.perf_counter()
        c = {name: _mesh_reduced(torch, dev, mesh, name) for name in ARCHS}
        log(f"mesh (c): {len(c)} reduced configs in "
            f"{time.perf_counter() - t0:.1f} s")

        # (e) a checkpoint round trip of the sharded state
        e = _mesh_checkpoint(torch, dev, mesh)
        log(f"mesh (e) {e['arch']} reduced on {smi}: one mesh step, the "
            f"DTensor state saved ({e['leaves']} leaves, "
            f"{e['bytes'] / 1e6:.3f} MB, {e['codec']}), restored, laid out "
            f"and stepped = the uninterrupted step 2 bit for bit (loss "
            f"{e['loss2']:.6f}, grad_norm {e['grad_norm2']:.6f}); objects = "
            f"the gathered state's byte for byte; save {e['save_s']:.3f} s "
            f"({e['save_mb_per_s']:.1f} MB/s; again {e['warm_save_s']:.3f} "
            f"s, {e['warm_save_mb_per_s']:.1f} MB/s), restore "
            f"{e['restore_s']:.3f}"
            f" s ({e['restore_mb_per_s']:.1f} MB/s); the gathered tree: "
            f"save {e['plain_save_s']:.3f} s "
            f"({e['plain_save_mb_per_s']:.1f} MB/s), restore "
            f"{e['plain_restore_s']:.3f} s "
            f"({e['plain_restore_mb_per_s']:.1f} MB/s)")
    finally:
        dist.destroy_process_group()

    # (d) the 2×2 card mesh, where the machine has the cards
    if cards >= MESH_CARDS:
        d = _mesh_cards(torch, arch, reduced, tokens, want, batch)
    else:
        log(f"mesh (d): the 2x2 card mesh was not run: this machine has "
            f"{cards} card(s) and it needs {MESH_CARDS}")
        d = {"run": False, "cards": cards}
    _sync(torch)
    launches = ext.launches()                # ... and ends here
    if launches:
        raise AssertionError(f"mesh path launched kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    log(f"mesh phase: {seconds:.1f} s")
    return {"card": smi, "serve": a, "train": b, "families": c,
            "checkpoint": e, "cards_2x2": d, "launches": launches,
            "tf32": False, "seconds": seconds}


def _mesh_card_rank(rank, world, port, arch, reduced, tokens, batch, out):
    """One rank of (d): card ``rank`` in a 2×2 (data, model) mesh over
    NCCL (gloo without a card); it serves and takes one train step as
    (a) and (b) do and runs (e)'s checkpoint round trip, and rank 0
    saves the logits, the step's metrics, its updated parameters and the
    round trip's record to ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as sh
    on_card = torch.cuda.is_available()
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = device_mesh(make_debug_mesh(2, 2), dev.type)
        plan = sh.make_plan(mesh)
        cfg = get_reduced(arch) if reduced else get_config(arch)

        def fresh():
            p = init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
            return sh.shard_tree(plan, p, sh.param_shardings(plan, p))
        tokens = tokens.to(dev)
        logits, _ = _mesh_serve(torch, cfg, fresh(), tokens,
                                SERVE_SHAPE["new_tokens"], mesh)
        first, ms, _, _ = _mesh_train(torch, cfg, fresh(),
                                      _tree_to(batch, dev), mesh, steps=2)
        ckpt = _mesh_checkpoint(torch, dev, mesh)
        if rank == 0:
            torch.save({"logits": [t.cpu() for t in logits], "train": first,
                        "train_ms": ms, "checkpoint": ckpt}, out)
    finally:
        dist.destroy_process_group()


def _mesh_cards(torch, arch, reduced, tokens, want, batch):
    """(d): four processes, one a card, on the 2×2 mesh, held against the
    one-card results of (a) (``want``: each step's logits) and (b),
    whose unsharded step runs again here to keep its parameters."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.model import init_params
    cfg = get_reduced(arch) if reduced else get_config(arch)
    dev = tokens.device
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/rank0.pt"
        t0 = time.perf_counter()
        mp.start_processes(_mesh_card_rank, args=(
            MESH_CARDS, _free_port(), arch, reduced, tokens.cpu(),
            _tree_to(batch, "cpu"), out), nprocs=MESH_CARDS,
            start_method="spawn")
        seconds = time.perf_counter() - t0
        got = torch.load(out)
    err = max(_rel_err(g, w, f"mesh (d) step {i}", MESH_REL)
              for i, (g, w) in enumerate(zip(got["logits"], want)))
    def fresh():
        return init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    # four cards sum in another order than one: the elements whose
    # first update that moves are held apart
    ill = _ill_elements(torch, cfg, fresh(), batch)
    want_t, _, _, _ = _mesh_train(torch, cfg, fresh(), batch, None)
    leaf = _hold_step(torch, got["train"], want_t, "mesh (d) train", ill)
    ck = got["checkpoint"]
    log(f"mesh (d) {arch} on the 2x2 mesh of {MESH_CARDS} cards: logits "
        f"within {err:.3g} of the one-card run's max, train step leaves "
        f"{leaf:.3g}, warm train step {got['train_ms']:.1f} ms; checkpoint "
        f"round trip ({ck['arch']} reduced) bit for bit, save "
        f"{ck['save_s']:.3f} s (again {ck['warm_save_s']:.3f} s), restore "
        f"{ck['restore_s']:.3f} s (gathered "
        f"tree {ck['plain_save_s']:.3f} / {ck['plain_restore_s']:.3f} s); "
        f"{seconds:.1f} s")
    return {"run": True, "cards": MESH_CARDS, "max_rel_err": err,
            "train_leaf_rel": leaf, "train_ms": got["train_ms"],
            "checkpoint": ck, "seconds": seconds}


if __name__ == "__main__":
    sys.exit(main())
