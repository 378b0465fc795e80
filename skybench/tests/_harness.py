"""Helpers of the benchmark's CPU tests: a whole run of a cell in a
subprocess, with the port's plain kernels, a small copy of the tables
(at the cell's rehearsal scale) and, where asked, the program broken
underneath."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the scale of a rehearsal whose configuration gives no
# ``rehearsal_scale_factor``
SF = 0.01


def rehearsal_sf(workload: str, root: Path = ROOT) -> float:
    """The scale factor a cell rehearses at: its configuration's
    ``rehearsal_scale_factor`` (a deployment whose joins repartition
    only above some size rehearses where they do), else ``SF``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    return float(cfg.get("rehearsal_scale_factor", SF))


def run_cell(workload: str, *, seed: int = 4242424242, seconds: float = 3,
             trace: int = 0, fault: str = "", cwd: Path = ROOT,
             timeout: float = 600) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of one rehearsal run; ``fault`` is
    Python run in the process before the harness starts."""
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu",
            "--sf", str(rehearsal_sf(workload, cwd))]
    code = (f"import sys; sys.path.insert(0, {str(cwd)!r}); "
            f"sys.path.insert(0, {str(cwd / 'src')!r})\n{fault}\n"
            f"from skybench import run\nsys.exit(run.main({args!r}))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def result(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
