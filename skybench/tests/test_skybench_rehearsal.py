"""A whole run of each cell on the CPU (the port's plain kernels, at the
cell's rehearsal scale, SF 0.01 unless its configuration says otherwise):
it reaches the result line, holds every answer to the reference, names
the CPU and fills no device metric; and the faults a run must catch."""

import json
import shutil
import sys

import pytest

from _harness import ROOT, result, run_cell

sys.path.insert(0, str(ROOT))
from skybench import workload  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# the metrics read off the card's trace: none is filled on the CPU
DEVICE_METRICS = {m["name"] for kind in ("end_to_end", "per_layer")
                  for m in BENCH[kind] if m["source"] == "device_trace"}

# faults planted in the program under a run: half of each scan's rows
# left out; a value altered where a fragment produces it
FAULTS = {
    "half_the_rows": """
import repro_torch.exec.fragment as fr
_load = fr._load_scan_table
def _half(*a, **k):
    cols = _load(*a, **k)
    return {c: v[: len(v) // 2] for c, v in cols.items()}
fr._load_scan_table = _half
""",
    "altered_answer": """
import numpy as np
import repro_torch.exec.fragment as fr
_to_numpy = fr.to_numpy
def _altered(block):
    out = _to_numpy(block)
    for c, v in out.items():
        if v.dtype == np.float64 and len(v):
            v[0] = v[0] * (1 + 1e-6) + 1e-6
    return out
fr.to_numpy = _altered
""",
}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_reaches_its_result_line(cell, trace):
    rc, out, err = run_cell(cell, trace=trace)
    assert rc == 0, err[-3000:]
    r = result(out)
    assert r["correct"] is True, err[-2000:]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    assert r["device"]["memory_peak_bytes"] is None
    assert list(r)[-1] == "checks"
    assert not DEVICE_METRICS & set(r["metrics"])
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])} - DEVICE_METRICS
    assert set(r["metrics"]) == want
    assert "pipelines served from the result cache: 0;" in out
    # every set the traffic can draw in a checkout's first run, the
    # sets of the run's own lists after it
    traffic = {w["name"]: w for w in BENCH["workloads"]}[cell]["traffic"]
    lists = workload.client_lists(
        workload.load(traffic, ROOT / "skybench"), 4242424242)
    own = len({t for lst in lists for q, _, t in lst if q in ("q1", "q6")})
    assert (f"scan kernels of {own} parameter sets" in out
            or "scan kernels of 141 parameter sets" in out)
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_reads_not_correct(cell, fault):
    rc, out, err = run_cell(cell, fault=FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is False


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "skybench", tmp_path / "skybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, out, _ = run_cell(CELLS[0], cwd=tmp_path)
    assert rc != 0
    assert '"correct"' not in out


def test_the_harness_loads_no_jax_and_no_reference_package():
    rc, out, err = run_cell(CELLS[0], fault="""
import importlib.abc
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Block())
""")
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is True


def test_a_forbidden_module_stops_the_result():
    rc, out, err = run_cell(CELLS[0], fault="""
import types
sys.modules["repro"] = types.ModuleType("repro")
""")
    assert rc != 0
    assert "repro" in err
    assert '"correct"' not in out
