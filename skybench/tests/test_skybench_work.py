"""The count behind ``kernels.fused_roofline`` (``skybench/work.py``):
a scan-fed pipeline counts as the scan-fed formula always counted, bit
for bit; an exchange-fed one from the rows its producers wrote into
their hash exchanges, by hand on made-up reports and on a whole CPU run
at SF 2, where the planner repartitions Q12's join."""

import json
import re
import shutil
import sys
import threading

import numpy as np
import pytest

from _harness import ROOT, result, run_cell

sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core.engine import PipelineReport  # noqa: E402
from skybench import peaks, tpchgen, work  # noqa: E402
from skybench import run as harness  # noqa: E402

SF1_ROWS = {"lineitem": 6_001_215, "orders": 1_500_000, "part": 200_000}
HBM = peaks.HBM_BYTES_PER_S


# -- the count as it stood before exchange-fed pipelines, frozen ---------------

_W = {c[0]: np.dtype(c[2]).itemsize
      for cols in tpchgen.SCHEMAS.values() for c in cols}
_SCANS = {
    "q1": (("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax"), None, (), 13),
    "q6": (("l_shipdate", "l_discount", "l_quantity", "l_extendedprice"),
           None, (), 7),
    "q12": (("l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate",
             "l_shipdate"), "orders", ("o_orderkey", "o_orderpriority"), 8),
    "q14": (("l_partkey", "l_shipdate", "l_extendedprice", "l_discount"),
            "part", ("p_partkey", "p_type"), 6),
    "q19": (("l_partkey", "l_quantity", "l_extendedprice", "l_discount",
             "l_shipmode", "l_shipinstruct"), "part",
            ("p_partkey", "p_brand", "p_container", "p_size"), 15),
}


def _old_bound_s(q, fused, fragments, rows):
    if q not in _SCANS or fused <= 0 or fragments <= 0:
        return 0.0
    cols, build, bcols, ops = _SCANS[q]
    probe = rows["lineitem"] * fused / fragments
    nbytes = probe * sum(_W[c] for c in cols)
    if build is not None:
        nbytes += fused * rows[build] * sum(_W[c] for c in bcols)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               probe * ops / peaks.FP64_FLOPS)


def _old_bound(run):
    bound = 0.0
    for qid, t, rep in run.pipelines_in_window():
        if rep.kernel in ("filter_agg", "groupby_onehot", "segmented_minmax",
                          "join_probe_agg") and not rep.cache_hit:
            q = run.kind_of_qid(qid)
            if q is not None:
                bound += _old_bound_s(q, rep.kernel_fragments,
                                      rep.n_fragments, run.table_rows)
    return bound


# -- made-up reports, held as the harness's recorder holds them ----------------

class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.pipelines, self.text_of = {}, {}


class _Trace:
    """A device trace whose fused kernels ran ``dev_s`` in all."""

    def __init__(self, dev_s):
        self.dev_s = dev_s

    def kernel_seconds(self):
        return {"spec_filter_agg_0": (self.dev_s, 1)}


def _report(pid, kernel="", n=1, fused=0, strategy="", parts=None,
            rows_out=0):
    return PipelineReport(
        pid=pid, sem_hash=f"s{pid}", n_fragments=n, kernel=kernel,
        kernel_fragments=fused, exchange_strategy=strategy,
        partition_stats=None if parts is None else
        [{"rows": r, "bytes": 12 * r, "kmv": [], "write_s": 0.0}
         for r in parts], rows_out=rows_out)


def _broadcast(q, n, fused):
    """The reports of a query whose join (if any) is broadcast: the
    build side's pipeline, the fused one, the merge."""
    reps = [_report(0, n=1, parts=[SF1_ROWS["part"]])] \
        if q in ("q12", "q14", "q19") else []
    return reps + [_report(len(reps), _KERNEL[q], n, fused),
                   _report(len(reps) + 1, n=1)]


_KERNEL = {"q1": "groupby_onehot", "q6": "filter_agg",
           "q12": "join_probe_agg", "q14": "join_probe_agg",
           "q19": "join_probe_agg"}


def _run(queries, rows=SF1_ROWS, dev_s=1e-3):
    """A run whose window saw ``queries``: (query, its reports)."""
    rec = _Recorder()
    for i, (q, reps) in enumerate(queries):
        qid = f"s1-q{i}"
        rec.text_of[qid] = f"text {i}"
        rec.pipelines[qid] = [(10.0 + i + 0.01 * j, r)
                              for j, r in enumerate(reps)]
    return harness.Run(
        recorder=rec, t_open=0.0, t_close=1e9, table_rows=rows,
        kind_of_text={f"text {i}": q for i, (q, _) in enumerate(queries)},
        trace=_Trace(dev_s), launches_in_window={})


def _roofline(run):
    return harness._metric_reader("kernels.fused_roofline")(run)


@pytest.mark.parametrize("q", ["q12", "q14", "q19"])
def test_a_broadcast_join_counts_as_the_scan_fed_formula(q):
    rng = np.random.default_rng(12)
    for _ in range(20):
        n = int(rng.integers(1, 28))
        fused = int(rng.integers(0, n + 1))
        run = _run([(q, _broadcast(q, n, fused))])
        (got,) = [b for _, _, _, b in work.fused_pipelines(run)]
        assert got == _old_bound_s(q, fused, n, SF1_ROWS)


def test_a_window_of_scan_fed_pipelines_reads_the_same_float():
    rng = np.random.default_rng(13)
    queries = []
    for _ in range(60):
        q = str(rng.choice(["q1", "q6", "q12", "q14", "q19", "q3"]))
        n = int(rng.integers(1, 28))
        queries.append((q, _broadcast(q, n, int(rng.integers(1, n + 1)))
                        if q != "q3" else [_report(0, "topk", 1, 1)]))
    run = _run(queries, dev_s=3.7e-2)
    bound = _old_bound(run)
    assert bound > 0
    assert _roofline(run) == 100.0 * bound / 3.7e-2


def _repartitioned(q, probe_parts, build_parts, fused=None, swap=False):
    """A repartitioned join's reports: the probe side's and the build
    side's hash exchanges (in the planner's order, or swapped), the
    fused join over their partitions, the merge."""
    n = len(probe_parts)
    sides = [_report(0, n=4, strategy="combining", parts=probe_parts),
             _report(1, n=1, strategy="direct", parts=build_parts)]
    if swap:
        sides = [_report(0, n=1, strategy="direct", parts=build_parts),
                 _report(1, n=4, strategy="combining", parts=probe_parts)]
    return sides + [_report(2, "join_probe_agg", n,
                            n if fused is None else fused),
                    _report(3, n=1)]


def test_a_repartitioned_q12_counts_its_exchange_rows():
    probe, build = [120, 80, 100, 95], [30_000, 29_000, 31_000, 30_500]
    run = _run([("q12", _repartitioned("q12", probe, build))])
    ((q, rep, feeders, b),) = list(work.fused_pipelines(run))
    assert [f.pid for f in feeders] == [0, 1]
    # l_orderkey 8 + l_shipmode 4; o_orderkey 8 + o_orderpriority 4
    assert b == (sum(probe) * 12 + sum(build) * 12) / HBM
    assert b < _old_bound_s("q12", 4, 4, SF1_ROWS)
    assert _roofline(run) == 100.0 * b / 1e-3


@pytest.mark.parametrize("swap", [False, True])
def test_a_repartitioned_q14_pairs_the_wider_side_with_fewer_rows(swap):
    probe, build = [1_000, 1_100], [50_000, 49_000]
    run = _run([("q14", _repartitioned("q14", probe, build, swap=swap))])
    ((_, _, _, b),) = list(work.fused_pipelines(run))
    # probe: l_partkey, l_extendedprice, l_discount (24 B); build:
    # p_partkey 8 + p_type 4; the pids, which the planner gives the
    # probe side first, do not decide the pairing
    assert b == (sum(probe) * 24 + sum(build) * 12) / HBM


def test_fused_fragments_read_the_fewest_rows():
    probe, build = [120, 80, 100, 95], [30_000, 29_000, 31_000, 30_500]
    run = _run([("q12", _repartitioned("q12", probe, build, fused=2))])
    ((_, _, _, b),) = list(work.fused_pipelines(run))
    assert b == ((30_000 + 29_000) * 12 + (80 + 95) * 12) / HBM


def test_a_producer_without_partition_stats_counts_its_rows_out():
    reps = [_report(0, n=2, strategy="combining", rows_out=700),
            _report(1, n=1, strategy="direct", rows_out=9_000),
            _report(2, "join_probe_agg", 2, 2)]
    run = _run([("q12", reps)])
    ((_, _, _, b),) = list(work.fused_pipelines(run))
    assert b == (700 * 12 + 9_000 * 12) / HBM


def test_a_hash_exchange_after_the_fused_pipeline_does_not_feed_it():
    """A fused pipeline that writes a hash exchange itself, or a later
    pipeline that does, leaves it scan-fed."""
    reps = [_report(0, n=1, parts=[200_000]),
            _report(1, "join_probe_agg", 6, 6, strategy="direct",
                    parts=[5, 5]),
            _report(2, n=2, strategy="direct", parts=[1, 1])]
    run = _run([("q14", reps)])
    ((_, _, feeders, b),) = list(work.fused_pipelines(run))
    assert feeders == []
    assert b == _old_bound_s("q14", 6, 6, SF1_ROWS)


def test_q12_at_sf2_reads_its_join_from_a_hash_exchange(tmp_path):
    """A whole traced CPU run of a Q12 cell made here, whose
    configuration rehearses at SF 2: the planner repartitions the join,
    and the fused join pipeline's bound comes from its exchange rows,
    below what the scan-fed formula gives the same pipeline."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "skybench", tmp_path / "skybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    cfg = json.loads((ROOT / "skybench/configs/tpch-sf1.json").read_text())
    cfg.update(name="q12-shuffle", rehearsal_scale_factor=2)
    (tmp_path / "skybench/configs/q12-shuffle.json").write_text(
        json.dumps(cfg))
    (tmp_path / "skybench/traffic/q12.json").write_text(json.dumps(
        {"clients": 1, "mix": {"q12": 1}, "queries_per_client": 20}))
    bench["configs"] = [dict(bench["configs"][0], name="q12-shuffle",
                             file="skybench/configs/q12-shuffle.json")]
    bench["workloads"] = [{"name": "q12-shuffle.q12",
                           "config": "q12-shuffle", "traffic": "q12",
                           "chips": 1, "why": "Q12 repartitioned at SF 2"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = run_cell("q12-shuffle.q12", seconds=6, trace=1,
                            cwd=tmp_path)
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is True
    assert "tables at SF 2 " in out
    (line,) = re.findall(r"roofline count (\{.*\})", out)
    count = json.loads(line)
    assert count["pipelines"] >= 1
    assert count["exchange_fed"] == count["pipelines"]
    assert count["bound_s"] < count["scan_fed_formula_s"]
    for fed in count["fed"]:
        assert fed["q"] == "q12" and len(fed["exchange_rows"]) == 2
        # both of Q12's sides carry 12 B a row
        assert fed["bound_s"] == sum(fed["exchange_rows"]) * 12 / HBM
        # the build side is the whole of orders at SF 2
        assert max(fed["exchange_rows"]) == 3_000_000
