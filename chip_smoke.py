"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
drives TPC-H Q6, Q1 and a grouped min/max query end to end at SF 1
through ``repro_torch.api.connect()`` (device: the card), checks every
stage-0 fragment ran its CUDA kernel and the rows equal the port's
oracle, then holds each kernel against its plain torch version at the
main path's shapes (plus the first 2^20 rows and the whole table, an
all-masked block and empty groups) and times both. Exits nonzero on any
failure. The last two lines are JSON: the kernel table, then
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM5 HBM3 (data sheet)
FP64_FLOPS = 34e12             # H100 SXM5 FP64 on the CUDA cores (data sheet)
RTOL = ATOL = 1e-9             # as the reference's row parity tests
REPS = 25
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
KERNELS = {   # dispatch kernel name → (wrapper module attr, CUDA source, TPU kernel)
    "filter_agg": ("fused_filter_agg", "filter_agg.cu",
                   "src/repro/kernels/filter_agg.py:134"),
    "groupby_onehot": ("fused_groupby", "groupby.cu",
                       "src/repro/kernels/groupby_onehot.py:118"),
    "segmented_minmax": ("fused_groupby_minmax", "groupby.cu",
                         "src/repro/kernels/segmented_minmax.py:90"),
}
LAUNCH_NAME = {"filter_agg": "filter_agg", "groupby_onehot": "groupby",
               "segmented_minmax": "groupby_minmax"}


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

    dev = torch.device("cuda", 0)
    state, launches = query_phase(torch, ext)
    try:
        kernels = kernel_phase(torch, dev, state, launches)
    finally:
        state["session"].close()
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- query phase: the port's main path -------------------------------------------

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


def query_phase(torch, ext, *, sf=1, device=None):
    import numpy as np
    from repro_torch.api import connect
    from repro_torch.sql import oracle
    from repro_torch.sql.logical import Binder
    from repro_torch.sql.parser import parse
    from repro_torch.sql.queries import QUERIES
    from repro_torch.sql.rules import optimize
    from repro_torch.storage import InputHandler

    session = connect(quota=16, device=device)
    t0 = time.perf_counter()
    catalog = session.ensure_tpch(sf=sf)
    log(f"ensure_tpch(sf={sf}): {time.perf_counter() - t0:.1f} s, device "
        f"{session.device}")
    ih = InputHandler(session.store)
    parts = [ih.read_table(f)[0] for f in catalog.tables["lineitem"].files]
    lineitem = {c.name: np.concatenate([p[c.name] for p in parts])
                for c in catalog.tables["lineitem"].schema}
    log(f"lineitem: {len(lineitem['l_orderkey'])} rows")

    # observe the fragments' FragmentStats as the workers return them
    records, lock = [], threading.Lock()
    inner = session.handler

    def handler(payload):
        resp, runtime = inner(payload)
        with lock:
            records.append(resp["stats"])
        return resp, runtime
    session.handler = handler

    queries = [("q6", QUERIES["q6"], "filter_agg"),
               ("q1", QUERIES["q1"], "groupby_onehot"),
               ("minmax", MINMAX_SQL, "segmented_minmax")]
    shapes = {}
    if session.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ext.reset_launches()                     # the main path starts here
    try:
        for name, sql, kernel in queries:
            records.clear()
            t0 = time.perf_counter()
            handle = session.submit(sql)
            res = handle.result(timeout=600)
            wall = time.perf_counter() - t0
            rows = res.fetch(session.store)
            stage0 = [p for p in res.stats.pipelines if p.kernel]
            if len(stage0) != 1 or stage0[0].kernel != kernel:
                raise AssertionError(f"{name}: kernel pipelines "
                                     f"{[p.kernel for p in stage0]}")
            p0 = stage0[0]
            ran = [s for s in records if s["kernel"] == kernel]
            if p0.kernel_fragments != p0.n_fragments or \
                    len(ran) != p0.n_fragments:
                raise AssertionError(
                    f"{name}: {p0.kernel_fragments} of {p0.n_fragments} "
                    f"stage-0 fragments on {kernel}")
            if f"kernel: {kernel} × {p0.n_fragments} fragments" \
                    not in handle.explain_analyze():
                raise AssertionError(f"{name}: explain_analyze lacks the "
                                     f"kernel line")
            lqp, _ = Binder(catalog).bind(parse(sql))
            _assert_rows(rows, oracle.run(optimize(lqp),
                                          {"lineitem": lineitem}), name)
            shapes[kernel] = max(s["rows_in"] for s in ran)
            log(f"query {name}: wall {wall:.3f} s, compute_s "
                f"{sum(s['compute_s'] for s in records):.6f} s over "
                f"{len(records)} fragments ({len(ran)} on {kernel}, "
                f"stage-0 compute_s "
                f"{sum(s['compute_s'] for s in ran):.6f} s), rows = oracle")
    except BaseException:
        session.close()
        raise
    finally:
        launches = ext.launches()            # ... and ends here
    log(f"launches on the main path: {launches}")
    if session.device.type == "cuda":
        log(f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        for kernel in KERNELS:
            if launches.get(LAUNCH_NAME[kernel], 0) < 1:
                session.close()
                raise AssertionError(f"{kernel}: no launch on the main path")
    return {"lineitem": lineitem, "rows": shapes, "catalog": catalog,
            "session": session}, launches


# -- kernel phase: each kernel against its plain version --------------------------

def _program_ops(prog, slot):
    from repro_torch.kernels.program import COL, CONST
    lo, hi = prog.slot_range(slot)
    return sum(1 for op, _ in prog.code[lo:hi].tolist()
               if op not in (COL, CONST))


def _bound(prog, cols, mask, out_numel):
    """Least time for this call: the bytes it must move (mask over the
    capacity, each program column over the valid rows, the output once)
    over HBM bandwidth, against the f64 operations these rows need over
    the FP64 peak."""
    n_valid = int(mask.sum())
    width = sum(cols[c].element_size() for c in prog.names)
    nbytes = mask.numel() + n_valid * width + out_numel * 8
    m = mask
    if prog.has_pred:
        from repro_torch.kernels.program import eval_slot
        m = mask & (eval_slot(prog, 0, cols) != 0)
    n_pass = int(m.sum())
    ops = n_valid * _program_ops(prog, 0) + n_pass * (
        _program_ops(prog, 1) + prog.n_aggs
        + sum(_program_ops(prog, 2 + a) for a in range(prog.n_aggs)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_FLOPS
    return nbytes, max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, flush, reps=REPS):
    """Median of ``reps`` CUDA-event-timed calls after warm-up, with the
    L2 cache flushed before each (the caller meets its block cold)."""
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


def _compare(kernel, got, want, ctx):
    import numpy as np
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        raise AssertionError(f"{ctx}: shape {g.shape} != {w.shape}")
    if kernel != "filter_agg":        # presence counts are exact
        if not np.array_equal(g[..., -1], w[..., -1]):
            raise AssertionError(f"{ctx}: presence differs")
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=ctx)
    finite = np.isfinite(w)
    return float(np.max(np.abs(g[finite] - w[finite]), initial=0.0))


def kernel_phase(torch, dev, state, launches):
    from repro_torch.core.engine import QueryEngine
    from repro_torch.exec import lower
    from repro_torch.exec.batch import bucket_capacity, from_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import filter_agg as fa
    from repro_torch.kernels import groupby_onehot as go
    from repro_torch.kernels import segmented_minmax as smm
    from repro_torch.sql.queries import QUERIES

    plain = {"filter_agg": fa.fused_filter_agg_plain,
             "groupby_onehot": go.fused_groupby_plain,
             "segmented_minmax": smm.fused_groupby_minmax_plain}
    session, lineitem = state["session"], state["lineitem"]
    engine = QueryEngine(session.store, state["catalog"],
                         platform=session.platform, handler=session.handler)
    sqls = {"filter_agg": QUERIES["q6"], "groupby_onehot": QUERIES["q1"],
            "segmented_minmax": MINMAX_SQL}
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MiB
    n_total = len(lineitem["l_orderkey"])
    table = []
    for kernel, sql in sqls.items():
        plan = engine.plan_sql(sql)
        m = next(lower.match_fragment(p.op) for p in plan.pipelines.values()
                 if p.kernel == kernel)
        prog, tiling = m.program, m.tiling
        wrapper = getattr(ops, KERNELS[kernel][0])
        names = list(prog.names)
        main_rows = state["rows"][kernel]
        results = {}
        for label, n in (("2^20", min(1 << 20, n_total)),
                         ("main", main_rows), ("all", n_total)):
            blk = from_numpy({c: lineitem[c][:n] for c in names},
                             bucket_capacity(n), dev)
            cols, mask = blk.columns, blk.mask
            got = wrapper(cols, mask, program=prog, tiling=tiling)
            want = plain[kernel](cols, mask, program=prog)
            torch.cuda.synchronize()
            err = _compare(kernel, got, want, f"{kernel} {label}")
            ms = _time_ms(torch, lambda: wrapper(cols, mask, program=prog,
                                                 tiling=tiling), flush)
            plain_ms = _time_ms(torch, lambda: plain[kernel](
                cols, mask, program=prog), flush, reps=5)
            nbytes, bound_ms, bound_by = _bound(prog, cols, mask,
                                                got.numel())
            results[label] = dict(rows=n, capacity=mask.numel(),
                                  max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  bytes=nbytes)
            log(f"kernel {kernel} {label}: {n} rows (capacity "
                f"{mask.numel()}), {ms * 1e3:.1f} us (median of {REPS}), "
                f"plain {plain_ms * 1e3:.1f} us, {nbytes} B moved, bound "
                f"{bound_ms * 1e3:.1f} us ({bound_by}), "
                f"{100 * bound_ms / ms:.1f}% of bound, max|err| {err:.3g}")
            del blk, cols, mask
        # the all-masked block and (for grouped kernels) empty groups
        n = 1 << 16
        blk = from_numpy({c: lineitem[c][:n] for c in names}, n, dev)
        cols = blk.columns
        none = torch.zeros(n, dtype=torch.bool, device=dev)
        _compare(kernel, wrapper(cols, none, program=prog,
                                 tiling=tiling),
                 plain[kernel](cols, none, program=prog),
                 f"{kernel} all-masked")
        if prog.n_groups:
            first = m.group_cols[0]
            some = blk.mask & (cols[first] == 0)
            got = wrapper(cols, some, program=prog, tiling=tiling)
            if not bool((got[:, -1] == 0).any()):
                raise AssertionError(f"{kernel}: no empty group in the "
                                     "empty-group case")
            _compare(kernel, got, plain[kernel](cols, some,
                                                program=prog),
                     f"{kernel} empty groups")
        log(f"kernel {kernel}: all-masked"
            f"{' and empty-group' if prog.n_groups else ''} cases = plain")
        main = results["main"]
        table.append({
            "name": KERNELS[kernel][0], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{KERNELS[kernel][1]}",
            "replaces": KERNELS[kernel][2],
            "launches": launches.get(LAUNCH_NAME[kernel], 0),
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "rows": main["rows"], "capacity": main["capacity"],
            "shapes": {k: {kk: v[kk] for kk in ("rows", "ms", "plain_ms",
                                                "bound_ms")}
                       for k, v in results.items()},
        })
    return table


if __name__ == "__main__":
    sys.exit(main())
