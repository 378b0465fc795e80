"""The plain reference against the port on the CPU, and the control
that the comparison has to reject."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from skybench import qgen, tpchgen, workload  # noqa: E402
from skybench.reference import compare, tpch as reference  # noqa: E402

SF, SEED = 0.01, 77
LIMIT = 1e-9


@pytest.fixture(scope="module")
def both():
    from repro_torch.api import connect
    from repro_torch.core import CoordinatorConfig
    s = connect(device="cpu", config=CoordinatorConfig(
        use_result_cache=False))
    s.ensure_tpch(sf=SF, seed=SEED)
    tabs = reference.Tables({t: tpchgen.concat(p) for t, p in
                             tpchgen.generate(SF, SEED).items()})
    yield s, tabs
    s.close()


def _drawn(q, n=4, seed=5):
    rng = workload.rng_for(seed, 9)
    draw = qgen.ParamDraw(q, rng)
    return [qgen.VALIDATION[q]] + [draw() for _ in range(n)]


@pytest.mark.parametrize("q", qgen.QUERIES)
def test_reference_gives_the_ports_rows(both, q):
    s, tabs = both
    for p in _drawn(q):
        got = s.sql(qgen.render(q, p)).fetch(s.store)
        why, gap = compare.judge(q, got, reference.answer(tabs, q, p))
        assert why is None, (q, p, why)
        assert gap <= LIMIT, (q, p, gap)


@pytest.mark.parametrize("q", ["q1", "q3", "q6", "q14", "q19"])
def test_float32_control_is_rejected(both, q):
    _, tabs = both
    gaps = []
    for p in _drawn(q, 8):
        want = reference.answer(tabs, q, p)
        why, gap = compare.judge(q, reference.answer(tabs, q, p,
                                                     np.float32), want)
        gaps.append(float("inf") if why else gap)
    assert max(gaps) > 10 * LIMIT, gaps


def test_judge_finds_each_kind_of_difference():
    want = {"l_shipmode": np.array([2, 5]),
            "high_line_count": np.array([3.0, 4.0]),
            "low_line_count": np.array([1.0, 0.0])}
    same = {k: v[::-1].copy() for k, v in want.items()}
    assert compare.judge("q12", same, want) == (None, 0.0)
    assert compare.judge("q12", {k: v[:1] for k, v in want.items()},
                         want)[0]
    keys = dict(want, l_shipmode=np.array([2, 6]))
    assert compare.judge("q12", keys, want)[0]
    off = dict(want, high_line_count=np.array([3.0, 4.0 + 4e-6]))
    assert compare.judge("q12", off, want) == (None, pytest.approx(1e-6))
    zero = dict(want, low_line_count=np.array([1.0, 1e-3]))
    assert compare.judge("q12", zero, want)[1] == pytest.approx(1e-3)
    assert compare.judge("q12", {"x": np.zeros(2)}, want)[0]


def test_control_runner_reads_not_correct_on_three_seeds():
    import json
    from skybench import control
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
        cfg = json.loads((ROOT / entry["file"]).read_text())
        traffic = workload.load(cell["traffic"], ROOT / "skybench")
        for seed in (1, 2, 3):
            r = control.readings(cfg, traffic, seed, 60, sf=SF)
            assert not r["correct"], r
            assert r["max_rel_gap"] > 10 * r["limit"], r
