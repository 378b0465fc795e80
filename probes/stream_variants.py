"""Time the Q6 and Bloom kernels the port keeps beside the variants it
does not keep (``probes/stream_variants.cu``), on the card, on the same
inputs: TPC-H SF 1 lineitem made by ``repro_torch.data.tpch`` with the
partitions and seed ``chip_smoke.py`` uses (5,999,653 rows).

- Q6: the kept ``ops.filter_agg`` and six variants, (price loaded for
  every group, only for a group with a passing row, the same with the
  next step's predicate columns loaded first) × (the last CTA folds, a
  second launch folds).
- Bloom: the kept ``ops.fused_bloom_filter`` (k at run time, the second
  wave in guarded batches of eight, compiled for at least 4 CTAs an SM)
  and copies of its kernel whose second wave has k = 6 compiled in (the
  five reads issued at once), k at run time with the reads one after
  another, or the kept batches; each compiled either as the kept kernel
  is or with the thread count alone in its launch bounds; over
  ``l_orderkey`` in a batch of capacity 2^23 (as the semi-join's probe
  scan has it) against a filter of 2^21 bits: the semi-join's own (the
  orders with ``o_totalprice > 500000``) and a dense one (every fourth
  order), where the second wave is taken.

Each is held against its plain version (Q6: count exact, revenue within
rtol 1e-4, two calls equal bits; Bloom: equal lane for lane), then timed
as ``chip_smoke.py`` times a kernel (median of 25 event-timed calls, L2
flushed; the profiler's device time over 10 calls), in the order
kept, variants..., variants reversed, kept. Prints a line a run, the
card's ``nvidia-smi`` line and, last, a JSON object of every time.

    python3 probes/stream_variants.py
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data.tpch import date_to_int, gen_orders_partition  # noqa: E402
from repro_torch.exec.batch import bucket_capacity, from_numpy  # noqa: E402
from repro_torch.kernels import bloom, ext, ops  # noqa: E402
from repro_torch.kernels import filter_agg as fa  # noqa: E402

Q6 = dict(date_lo=date_to_int("1994-01-01"), date_hi=date_to_int("1995-01-01"),
          disc_lo=0.05, disc_hi=0.07, qty_hi=24.0)
PRICE = {0: "price every group", 1: "price on a pass",
         2: "price on a pass, next loads first"}
WAVE = {0: "k 6 compiled in", 1: "reads one after another",
        2: "guarded batches"}
BLOOM_VARIANTS = ((0, 0), (0, 1), (1, 1), (2, 0), (2, 1))
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _build() -> ctypes.CDLL:
    out = ext.BUILD_DIR / "probes" / "libstream_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [ext._nvcc(), *ext.nvcc_flags("filter_agg_q6"), f"-I{ext.CSRC}",
           "-o", str(out), str(ROOT / "probes" / "stream_variants.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    print("\n".join(ln for ln in r.stderr.splitlines()
                    if "registers" in ln or "entry function" in ln),
          flush=True)
    lib = ctypes.CDLL(str(out))
    lib.q6_variant_launch.argtypes = [_P, _P, _P, _P, _L, _L, _I, _I, _F,
                                      _F, _F, _P, _P, _P, _I, _I, _I, _P]
    lib.bloom_variant_launch.argtypes = [_P, _P, _L, _L, _P, _L, _I, _P, _I,
                                         _I, _P]
    lib.q6_variant_launch.restype = lib.bloom_variant_launch.restype = _I
    return lib


def _tables():
    li, orders = {}, {}
    for p in range(6):
        t = gen_orders_partition(1.0, p, 6, seed=0)
        for name, dst, cols in (
                ("lineitem", li, ("l_orderkey", "l_shipdate", "l_discount",
                                  "l_quantity", "l_extendedprice")),
                ("orders", orders, ("o_orderkey", "o_totalprice"))):
            for c in cols:
                dst.setdefault(c, []).append(t[name][c])
    return ({c: np.concatenate(v) for c, v in li.items()},
            {c: np.concatenate(v) for c, v in orders.items()})


def _runs(sm, flush, calls, expect):
    """{label: [(window ms, device ms)] * 2}, kept first and last, after
    one untimed pass over every call (a process's first timed calls of a
    shape run slow)."""
    for fn in calls.values():
        sm._time_ms(torch, fn, flush, reps=3)
    order = list(calls) + list(reversed(calls))
    out = {label: [] for label in calls}
    for label in order:
        fn = calls[label]
        ms = sm._time_ms(torch, fn, flush)
        dev = sum(v for v, _ in sm._kernel_times(
            torch, fn, expect[label], 10, flush).values())
        out[label].append((ms, dev))
        print(f"{label}: {ms:.4f} ms, device {dev:.4f} ms", flush=True)
    return out


def q6_probe(sm, lib, li, dev, flush):
    n = len(li["l_shipdate"])
    cols = [torch.from_numpy(li["l_shipdate"].astype(np.int32)).to(dev)] + [
        torch.from_numpy(li[c].astype(np.float32)).to(dev)
        for c in ("l_discount", "l_quantity", "l_extendedprice")]
    want = fa.filter_agg_plain(*cols, **Q6)
    _, groups, _ = fa.q6_layout([c.data_ptr() for c in cols], n)
    max_ctas = ext.sm_count(dev) * fa.MAX_CTAS_PER_SM
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def variant(price, use_ticket):
        def call():
            partials = torch.empty((max_ctas, 2), dtype=torch.float32,
                                   device=dev)
            out = torch.empty((2,), dtype=torch.float32, device=dev)
            rc = lib.q6_variant_launch(
                *(c.data_ptr() for c in cols), n, groups, Q6["date_lo"],
                Q6["date_hi"], Q6["disc_lo"], Q6["disc_hi"], Q6["qty_hi"],
                partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                max_ctas, price, use_ticket, stream)
            if rc:
                raise RuntimeError(f"q6 variant {price}/{use_ticket}: {rc}")
            return out
        return call
    calls = {"kept": lambda: ops.filter_agg(*cols, **Q6)}
    expect = {"kept": {"q6_kernel": 1}}
    for price in PRICE:
        for use_ticket in (1, 0):
            label = f"{PRICE[price]}, " + ("ticket" if use_ticket
                                          else "second launch")
            calls[label] = variant(price, use_ticket)
            expect[label] = {"q6_variant": 1,
                             **({} if use_ticket else {"fold_kernel": 1})}
    for label, fn in calls.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if float(got[1]) != float(want[1]):
            raise AssertionError(f"Q6 {label}: count {float(got[1])} != "
                                 f"{float(want[1])}")
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4,
                                   err_msg=f"Q6 {label}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"Q6 {label}: two calls differ")
    print(f"Q6: {n} rows, {int(want[1])} pass", flush=True)
    return _runs(sm, flush, calls, expect)


def bloom_probe(sm, lib, li, orders, dev, flush):
    keys_np = li["l_orderkey"]
    blk = from_numpy({"k": keys_np}, bucket_capacity(len(keys_np)), dev)
    keys, mask = blk.columns["k"], blk.mask
    bits = 1 << 21
    _, chunks, _ = bloom.vector_layout(keys.data_ptr(), keys.element_size(),
                                       mask.data_ptr(), mask.data_ptr(),
                                       mask.numel())
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for name, members in (
            ("semi-join filter",
             orders["o_orderkey"][orders["o_totalprice"] > 500000]),
            ("dense filter", orders["o_orderkey"][::4])):
        words = bloom.words_tensor(bloom.bloom_build(
            members.astype(np.uint32), bits), dev)

        def variant(wave, min4, words=words):
            def call():
                v = torch.empty_like(mask)
                rc = lib.bloom_variant_launch(
                    keys.data_ptr(), mask.data_ptr(), mask.numel(), chunks,
                    words.data_ptr(), bits, 6, v.data_ptr(), wave, min4,
                    stream)
                if rc:
                    raise RuntimeError(f"bloom variant {wave}: {rc}")
                return v
            return call
        calls = {"kept": lambda words=words: ops.fused_bloom_filter(
            keys, mask, words=words, bits=bits, k=6, tiling=None)}
        expect = {"kept": {"bloom_kernel": 1}}
        for wave, min4 in BLOOM_VARIANTS:
            label = f"{WAVE[wave]}, launch bounds " + (
                "(256, 4)" if min4 else "(256)")
            calls[label] = variant(wave, min4)
            expect[label] = {"bloom_variant": 1}
        want = bloom.fused_bloom_filter_plain(keys, mask, words=words,
                                              bits=bits, k=6)
        for label, fn in calls.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"Bloom {name} {label}: verdicts differ")
        first = int((bloom.bloom_probe_plain(keys, words, bits, k=1)
                     & mask).sum())
        print(f"Bloom {name}: {len(members)} members, {first} of "
              f"{len(keys_np)} valid rows pass the first probe, "
              f"{int(want.sum())} all six", flush=True)
        out[name] = {"members": len(members), "first_probe": first,
                     "runs": _runs(sm, flush, calls, expect)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sm = _smoke()
    t0 = time.perf_counter()
    ext.build_all()
    lib = _build()
    li, orders = _tables()
    print(f"build and data: {time.perf_counter() - t0:.1f} s", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    result = {"q6": q6_probe(sm, lib, li, dev, flush),
              "bloom": bloom_probe(sm, lib, li, orders, dev, flush)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result["nvidia_smi"] = smi
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
