"""The slice end to end: TPC-H Q6, Q1 and the grouped min/max query through
``repro.api.connect`` and ``repro_torch.api.connect(device="cpu")``.

Sorted rows agree within rtol = atol = 1e-9 (as the reference's parity
tests) and equal the oracle; each pipeline lowers to the same kernel in
both packages, and the stage-0 fragments report it in FragmentStats."""

import re
import threading

import numpy as np
import pytest

from _explain import JOIN_SORT_AGG, without_join_sort_agg
import repro.api as ref_api
from repro.exec import lower as ref_lower
import repro_torch.api as port_api
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize

TOL = dict(rtol=1e-9, atol=1e-9)
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
CASES = {"q6": (QUERIES["q6"], "filter_agg"),
         "q1": (QUERIES["q1"], "groupby_onehot"),
         "minmax": (MINMAX_SQL, "segmented_minmax")}


class _Recorder:
    """Wraps a session's worker handler to keep each fragment's stats."""

    def __init__(self, session):
        self.stats, self._lock, self._inner = [], threading.Lock(), \
            session.handler
        session.handler = self

    def __call__(self, payload):
        resp, runtime = self._inner(payload)
        with self._lock:
            self.stats.append(resp["stats"])
        return resp, runtime


@pytest.fixture(scope="module")
def sessions():
    ref = ref_api.connect(tier="local", quota=8)
    port = port_api.connect(tier="local", quota=8, device="cpu")
    ref.ensure_tpch(sf=0.01, n_parts=4)
    catalog = port.ensure_tpch(sf=0.01, n_parts=4)
    rec = _Recorder(port)
    yield ref, port, catalog, rec
    ref.close()
    port.close()


def _sorted_rows(cols):
    keys = sorted(cols)
    arrs = [np.asarray(cols[k], np.float64) for k in keys]
    order = np.lexsort(arrs)
    return {k: a[order] for k, a in zip(keys, arrs)}


def _assert_same_rows(a, b, ctx):
    sa, sb = _sorted_rows(a), _sorted_rows(b)
    assert sorted(sa) == sorted(sb), ctx
    for k in sa:
        np.testing.assert_allclose(sa[k], sb[k], err_msg=f"{ctx} :: {k}",
                                   **TOL)


def _lineitem(session, catalog):
    from repro_torch.storage import InputHandler
    ih = InputHandler(session.store)
    parts = [ih.read_table(f)[0] for f in catalog.tables["lineitem"].files]
    return {c.name: np.concatenate([p[c.name] for p in parts])
            for c in catalog.tables["lineitem"].schema}


@pytest.mark.parametrize("query", sorted(CASES))
def test_rows_kernels_and_stats_match(sessions, query):
    ref, port, catalog, rec = sessions
    sql, kernel = CASES[query]
    want = ref.sql(sql)
    rec.stats.clear()
    got = port.sql(sql)
    ref_rows, port_rows = want.fetch(ref.store), got.fetch(port.store)
    _assert_same_rows(port_rows, ref_rows, f"{query} vs repro")
    lqp, _ = Binder(catalog).bind(parse(sql))
    truth = oracle.run(optimize(lqp), {"lineitem": _lineitem(port, catalog)})
    _assert_same_rows(port_rows, truth, f"{query} vs oracle")
    # same kernel name per pipeline in both packages
    assert [p.kernel for p in got.stats.pipelines] == \
        [p.kernel for p in want.stats.pipelines]
    stage0 = [p for p in got.stats.pipelines if p.kernel]
    assert [p.kernel for p in stage0] == [kernel]
    assert stage0[0].kernel_fragments == stage0[0].n_fragments >= 1
    # FragmentStats.kernel of the stage-0 fragments
    ran = [s["kernel"] for s in rec.stats if s["kernel"]]
    assert ran == [kernel] * stage0[0].n_fragments
    assert all(s["compute_s"] >= 0 for s in rec.stats)


@pytest.mark.parametrize("query", sorted(CASES))
def test_generic_torch_path_matches_the_kernel_path(sessions, query):
    """With dispatch off every fragment runs the generic torch operators;
    rows equal the kernel path's (the result cache is keyed by the plan,
    so a fresh session keeps the two runs apart)."""
    from repro_torch.exec import lower
    sql = CASES[query][0]
    _, port, _, _ = sessions
    fused = port.sql(sql).fetch(port.store)
    s = port_api.connect(tier="local", quota=8, device="cpu")
    try:
        s.ensure_tpch(sf=0.01, n_parts=4)
        with lower.disabled():
            res = s.sql(sql)
        assert not any(p.kernel for p in res.stats.pipelines)
        _assert_same_rows(res.fetch(s.store), fused, f"{query} generic")
    finally:
        s.close()


def _strip_tiling(text):
    # the port's scan arms compile per program and show no tiling
    text = re.sub(r"( kernel=(filter_agg|groupby_onehot|segmented_minmax))"
                  r" block=\d+ resident=\d+ \(\w+-bound\)", r"\1", text)
    return re.sub(r" block=\d+ resident=\d+", "", text)


@pytest.mark.parametrize("query", ["q6", "q1", "minmax", "q12", "q3",
                                   "q14", "q19"])
def test_explain_matches_apart_from_tiling_and_unported_arms(sessions,
                                                             query):
    """Same plans and kernel arms as repro's EXPLAIN, with repro's
    interpret-cost gate off (the port has none: on the CPU its arms run
    their plain versions); only the tiling numbers differ."""
    ref, port, _, _ = sessions
    sql = CASES[query][0] if query in CASES else QUERIES[query]
    with ref_lower.interpret_gate_disabled():
        want = ref.explain(sql)
    got = port.explain(sql)
    # the port's own sort_agg arm over joins, which the reference misses
    got, n = without_join_sort_agg(_strip_tiling(got))
    assert n == JOIN_SORT_AGG.get(query, 0)
    assert got == _strip_tiling(want)


def test_a_query_off_the_slice_fails_naming_the_slice(sessions):
    """Q3 under the default planner at SF 0.01: its final stage is fused
    into the merge pipeline (``… → project → final``), so no top-k arm;
    its join stage runs the port's own ``sort_agg`` arm over joins (the
    reference's arm takes only a scan chain); none waits for an unported
    kernel. It runs on the CPU and equals the oracle. (Under the
    benchmark planner its final runs ``topk``:
    ``tests/test_torch_sort.py``.)"""
    _, port, catalog, _ = sessions
    res = port.sql(QUERIES["q3"], timeout=120)
    assert [p.kernel for p in res.stats.pipelines if p.kernel] == \
        ["sort_agg"]
    assert not any("not yet ported" in p.kernel_miss_reason
                   for p in res.stats.pipelines)
    from repro_torch.storage import InputHandler
    ih = InputHandler(port.store)
    tables = {}
    for name in ("lineitem", "orders", "customer"):
        meta = catalog.tables[name]
        parts = [ih.read_table(f)[0] for f in meta.files]
        tables[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                        for c in meta.schema}
    lqp, _ = Binder(catalog).bind(parse(QUERIES["q3"]))
    _assert_same_rows(res.fetch(port.store),
                      oracle.run(optimize(lqp), tables), "q3 vs oracle")


def test_unported_arms_name_their_kernel():
    """Every arm of the reference's dispatch lowers to its kernel in the
    port: the sort-aggregate and top-k arms too, since slice 3."""
    from repro_torch.exec import lower
    scan = {"t": "scan_table", "columns": ["a", "b"]}
    ported = {
        "sort_agg": {"t": "partial_agg", "strategy": "sort",
                     "group_cols": ["a"], "sizes": None,
                     "aggs": [["c", "count", None]], "child": scan},
        "topk": {"t": "final", "sort_keys": [["a", True]], "limit": 5,
                 "project": None, "child": scan},
        "bloom_filter": {"t": "semijoin_probe", "key": "a", "bits": 1024,
                         "k": 6, "child": scan},
        "join_probe_agg": {"t": "partial_agg", "strategy": "direct",
                           "group_cols": [], "sizes": [],
                           "aggs": [["c", "count", None]],
                           "child": {"t": "join", "probe": scan,
                                     "build": scan, "probe_key": "a",
                                     "build_key": "b", "payload": []}},
    }
    for kernel, op in ported.items():
        assert lower.kernel_miss_reason(op) is None
        assert lower.match_kernel(op) == kernel
        assert lower.lower_fragment(op).kernel == kernel


def test_semijoin_probe_runs_on_the_host_only_on_the_cpu(sessions,
                                                        monkeypatch):
    """A single-integer-key Bloom filter on a probe-side scan chain wraps
    the scan in the ``bloom_filter`` arm on every device, as the
    reference does: on the CPU its plain version kills the rows the host
    probe would, and the host probe is not called. A ``hash64`` filter
    (the key shapes the kernel cannot take) and a project-rooted chain
    (the shape the arm does not match) still probe on the host, killing
    the same rows."""
    from repro_torch.exec import fragment
    from repro_torch.kernels import bloom
    _, port, catalog, _ = sessions
    li = catalog.tables["lineitem"]
    keys = _lineitem(port, catalog)["l_orderkey"]
    build = np.unique(keys)[::7]
    col = next(c for c in li.schema if c.name == "l_orderkey")

    def spec(mode):
        ku = bloom.keys_u32({"k": build}, ["k"], mode)
        words = bloom.bloom_build(ku, bloom.bloom_bits_for(build.size),
                                  bloom.BLOOM_K)
        return {"op": {"t": "scan_table", "table": "lineitem",
                       "columns": ["l_orderkey"], "zone_preds": []},
                "scan_units": list(li.files), "fragment": 0,
                "n_fragments": 1,
                "semijoin": dict(bloom.bloom_to_wire(words, mode=mode),
                                 key=["l_orderkey"]),
                "output": {"schema": [{"name": col.name, "kind": col.kind,
                                       "dtype": col.dtype}],
                           "partitioning": {"kind": "single"},
                           "prefix": f"test/semijoin_probe_{mode}"}}, words

    u32, words = spec("u32")
    hit = bloom.bloom_probe_np(keys.astype(np.uint32), words,
                               words.size * 32, bloom.BLOOM_K)
    host_probe = bloom.bloom_probe_np

    def no_host_probe(*a, **k):
        raise AssertionError("host Bloom probe of a u32 filter")
    monkeypatch.setattr(bloom, "bloom_probe_np", no_host_probe)
    res = fragment.execute_fragment(port.store, u32, device="cpu")
    assert res.stats.kernel == "bloom_filter"
    assert res.stats.semijoin_killed == int((~hit).sum()) > 0
    assert res.stats.rows_out == int(hit.sum())

    calls = []
    monkeypatch.setattr(bloom, "bloom_probe_np",
                        lambda *a, **k: calls.append(1) or host_probe(*a,
                                                                      **k))
    h64, words64 = spec("hash64")
    res = fragment.execute_fragment(port.store, h64, device="cpu")
    ku = bloom.keys_u32({"l_orderkey": keys}, ["l_orderkey"], "hash64")
    hit64 = host_probe(ku, words64, words64.size * 32, bloom.BLOOM_K)
    assert calls and res.stats.kernel == ""
    assert res.stats.semijoin_killed == int((~hit64).sum()) > 0

    calls.clear()
    proj = dict(u32, op={"t": "project", "exprs": [
        ["l_orderkey", {"t": "col", "name": "l_orderkey"}]],
        "child": u32["op"]})
    res = fragment.execute_fragment(port.store, proj, device="cpu")
    assert calls and res.stats.kernel == ""
    assert res.stats.semijoin_killed == int((~hit).sum())


def test_connect_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        s = port_api.connect(tier="local")
        assert s.device.type == "cuda"
        s.close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_api.connect(tier="local")
