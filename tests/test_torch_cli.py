"""The port's SQL driver, ``python -m repro_torch.launch.sql``, against the
reference's ``repro.launch.sql``: the same flags print the same plans
(apart from tiling) and the same rows, through the session and through
the service tier. Fragments run on the card unless ``--device cpu`` is
given; without a card the driver exits nonzero, names the missing card
and prints no rows."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from _explain import JOIN_SORT_AGG, without_join_sort_agg
from repro.exec import lower as ref_lower
from repro.launch import sql as ref_sql
from repro_torch.launch import sql as port_sql
from repro_torch.sql.queries import QUERIES

SRC = Path(port_sql.__file__).resolve().parents[2]


def _main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["sql"] + argv)
    module.main()
    return capsys.readouterr().out


def _both(argv, monkeypatch, capsys):
    """(reference output, port output) of one command line, the port's
    fragments on the CPU."""
    want = _main(ref_sql, argv, monkeypatch, capsys)
    got = _main(port_sql, argv + ["--device", "cpu"], monkeypatch, capsys)
    return want, got


def _strip_tiling(text):
    # the port's scan arms compile per program and show no tiling
    text = re.sub(r"( kernel=(filter_agg|groupby_onehot|segmented_minmax))"
                  r" block=\d+ resident=\d+ \(\w+-bound\)", r"\1", text)
    return re.sub(r" block=\d+ resident=\d+", "", text)


def _driver_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("[sql] ")]


def _plans(out):
    return "\n".join(ln for ln in out.splitlines()
                     if not ln.startswith("[sql] "))


def _tables(out):
    """Each result's status line (its id cut off), column header and
    printed rows, in order."""
    blocks, cur = [], None
    for ln in out.splitlines():
        head = re.match(r"\[[^\]]+\] (result @|SUCCEEDED|FAILED|CANCELLED)",
                        ln)
        if head:
            cur = [re.sub(r" @ .*", "", ln.split("] ", 1)[1])]
            blocks.append(cur)
        elif re.match(r"\[[^\]]+\] sim latency", ln):
            cur = None
        elif cur is not None and ln.strip():
            cur.append(ln)
    return blocks


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_explain_prints_the_reference_plans(qname, monkeypatch, capsys):
    # the reference's kernel arms matched as on a compiled backend: the
    # port has no interpret-cost gate
    with ref_lower.interpret_gate_disabled():
        want, got = _both(["--query", qname, "--explain"], monkeypatch,
                          capsys)
    # the port's own sort_agg arm over joins, which the reference misses
    plans, n = without_join_sort_agg(_strip_tiling(_plans(got)))
    assert n == JOIN_SORT_AGG.get(qname, 0)
    assert plans == _strip_tiling(_plans(want))
    assert "physical plan" in _plans(got)
    assert "[sql] device cpu" in _driver_lines(got)


@pytest.mark.parametrize("argv", [
    ["--query", "q6"],
    ["--query", "q1,q12"],
    ["--query", "q6", "--tenant", "t"],
    ["--query", "q6,q12", "--tenant", "t", "--deadline", "10",
     "--budget-cents", "50"],
], ids=["q6", "q1-q12", "q6-service", "q6-q12-service-slo"])
def test_rows_equal_the_reference_cli(argv, monkeypatch, capsys):
    want, got = _both(argv, monkeypatch, capsys)
    assert _tables(got) == _tables(want)
    n = len(argv[1].split(","))
    assert len(_tables(got)) == n and all(len(t) >= 3
                                          for t in _tables(got))
    if "--tenant" in argv:
        assert [t[0] for t in _tables(got)] == \
            ["SUCCEEDED (tenant=t, attempt=0)"] * n
        summary = [re.sub(r"svc-\w+|\d+\.\d+", "#", ln)
                   for ln in _driver_lines(got) + _driver_lines(want)
                   if ln.startswith("[sql] service")]
        assert len(summary) == 2 and summary[0] == summary[1]
        assert f"{{'SUCCEEDED': {n}}}" in summary[0]


def test_without_a_card_the_service_path_refuses_to_start(monkeypatch,
                                                          capsys):
    """No ``--device`` and no CUDA: the driver stops before it generates
    data or prints a row, and its message names the missing card."""
    monkeypatch.setattr(sys, "argv", ["sql", "--query", "q6", "--tenant",
                                      "t"])
    with pytest.raises(SystemExit) as ei:
        port_sql.main()
    assert "no CUDA device" in str(ei.value.code)
    assert "--device cpu" in str(ei.value.code)
    assert capsys.readouterr().out == ""


def test_without_a_card_the_module_exits_nonzero():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sql", "--query", "q6"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""
