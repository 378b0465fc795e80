"""The control of a cell's comparison: the reference, computed in float32,
put in the program's place.

    python3 -m skybench.control --workload <cell> --seeds 1 2 3 [--queries N]

For each seed it makes the cell's tables and the first ``N`` queries its
clients would send (``skybench.workload``), answers them with the
reference in float64 (what a run compares with) and in float32 (the
nearest precision below the configuration's float64), and judges the
float32 answers exactly as a run judges the program's. The control has
to come out not correct on every seed; the smallest largest-gap it
reads is the upper reading that the cell's ``check.max_rel_gap`` stays
under. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from skybench import tpchgen, workload  # noqa: E402
from skybench.reference import compare, tpch as reference  # noqa: E402


def readings(cfg: dict, traffic: dict, seed: int,
             n_queries: int, sf: float | None = None) -> dict:
    """The control's numbers on one seed, as a run would print them."""
    sf = float(cfg["scale_factor"]) if sf is None else sf
    with ThreadPoolExecutor(8) as pool:
        parts = tpchgen.generate(sf, seed, cfg.get("n_parts"), pool)
    tabs = reference.Tables({t: tpchgen.concat(p) for t, p in parts.items()})
    seq = workload.sequence(traffic, seed)[:n_queries]

    def judge(entry):
        q, p, _ = entry
        want = reference.answer(tabs, q, p)
        return compare.judge(q, reference.answer(tabs, q, p, np.float32),
                             want)

    with ThreadPoolExecutor(4) as pool:
        verdicts = list(pool.map(judge, seq))
    limit = float(cfg["check"]["max_rel_gap"])
    wrong = sum(why is not None for why, _ in verdicts)
    gap = max([g for why, g in verdicts if why is None] or [0.0])
    over = sum(why is not None or g > limit for why, g in verdicts)
    return {"seed": seed, "queries": len(seq), "wrong_answers": wrong,
            "max_rel_gap": gap, "limit": limit,
            "failed_queries": over, "correct": over == 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m skybench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--queries", type=int, default=120)
    ap.add_argument("--sf", type=float, default=None)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = workload.load(cell["traffic"], BENCH)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cfg, traffic, seed, args.queries, args.sf)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
