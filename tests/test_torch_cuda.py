"""The port on the card: each CUDA kernel against its plain version (the
scan kernels compiled per program, at both grouped skeletons, with
min/max edge values, repeatability, local memory and the compile cache
checked too), and the slices end to end on the default device (Q6, Q1,
min/max; Q12, Q14, Q19 and the selective semi-join; the GROUP BY
l_orderkey and Q3 of the sort path); and the four kernels no query
reaches (the fixed-layout Q6 and grouped sums, flash attention, the SSD
scan), each against its plain version, with inputs its wrapper must
refuse.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports neither ``jax`` nor ``repro``, so it runs on a machine
without JAX; there, skip the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.api import connect
from repro_torch.exec import lower
from repro_torch.exec.batch import bucket_capacity, from_numpy
from repro_torch.exec.fragment import _device_scope
from repro_torch.analysis import roofline
from repro_torch.core import CoordinatorConfig
from repro_torch.kernels import bloom, ext, ops, specialise
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import join_probe as jp
from repro_torch.kernels import groupby_onehot as go
from repro_torch.kernels import segmented_minmax as smm
from repro_torch.kernels import sort_agg as sa
from repro_torch.kernels import topk as tk
from repro_torch.kernels.program import compile_program, for_columns
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-9, atol=1e-9)
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
SQLS = {"q6": QUERIES["q6"], "q1": QUERIES["q1"], "minmax": MINMAX_SQL}
WRAPPERS = {"filter_agg": (ops.fused_filter_agg, fa.fused_filter_agg_plain),
            "groupby_onehot": (ops.fused_groupby, go.fused_groupby_plain),
            "segmented_minmax": (ops.fused_groupby_minmax,
                                 smm.fused_groupby_minmax_plain)}


@pytest.fixture(scope="module")
def session():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have "
                    "no CPU mode")
    s = connect(tier="local", quota=8)
    catalog = s.ensure_tpch(sf=0.01, n_parts=4)
    yield s, catalog, _tables(s, catalog)["lineitem"]
    s.close()


def _tables(s, catalog):
    ih = InputHandler(s.store)
    out = {}
    for name in ("lineitem", "orders", "part", "customer"):
        parts = [ih.read_table(f)[0] for f in catalog.tables[name].files]
        out[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                     for c in catalog.tables[name].schema}
    return out


def _match(s, sql):
    from repro_torch.core.engine import QueryEngine
    plan = QueryEngine(s.store, s.catalog, platform=s.platform,
                       handler=s.handler).plan_sql(sql)
    return next(lower.match_fragment(p.op) for p in plan.pipelines.values()
                if p.kernel)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("query", sorted(SQLS))
def test_kernel_matches_plain(session, query, capacity):
    s, _, lineitem = session
    m = _match(s, SQLS[query])
    wrapper, plain = WRAPPERS[m.kernel]
    n = min(capacity, len(lineitem["l_orderkey"]))
    dev = torch.device("cuda", 0)
    cols = {c: torch.zeros(capacity, dtype=torch.from_numpy(lineitem[c]).dtype,
                           device=dev) for c in m.program.names}
    for c in cols:
        cols[c][:n] = torch.from_numpy(lineitem[c][:n]).to(dev)
    mask = torch.zeros(capacity, dtype=torch.bool, device=dev)
    mask[:n] = True
    counter = {"filter_agg": "filter_agg", "groupby_onehot": "groupby",
               "segmented_minmax": "groupby_minmax"}[m.kernel]
    before = ext.launches().get(counter, 0)
    got = wrapper(cols, mask, program=m.program, tiling=m.tiling)
    want = plain(cols, mask, program=m.program)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float64
    assert ext.launches().get(counter, 0) == before + 1
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if m.kernel != "filter_agg":
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


def _nested_sum(names, op="+"):
    """c0 op (c1 op (c2 op ...)): the postfix program pushes every column
    before its first operator, a stack as deep as there are columns."""
    e = _col(names[-1])
    for n in reversed(names[:-1]):
        e = {"t": "bin", "op": op, "l": _col(n), "r": e}
    return e


@pytest.mark.parametrize("depth", [3, 6, 11, 15])
@pytest.mark.parametrize("grouped", [False, True])
def test_interpreter_stack_depths_match_plain(session, depth, grouped):
    """Programs as deep as the stack limit allows, in the predicate and
    the aggregate arguments, against the plain version (the compiled
    kernels hold each stack position in a local of its own)."""
    rng = np.random.default_rng(depth + grouped)
    dev = torch.device("cuda", 0)
    n = 1 << 16
    names = [f"c{i}" for i in range(depth)]
    cols = {c: torch.from_numpy(rng.normal(size=n)).to(dev) for c in names}
    cols["g"] = torch.from_numpy(rng.integers(0, 4, n).astype(
        np.int32)).to(dev)
    pred = {"t": "cmp", "op": ">", "l": _nested_sum(names), "r": _lit(0)}
    aggs = [("sum", _nested_sum(names, "*")), ("count", None),
            ("max", _nested_sum(names, "-"))]
    prog = compile_program([pred], aggs,
                           group_cols=["g"] if grouped else None,
                           strides=[1] if grouped else None,
                           n_groups=4 if grouped else 0)
    assert prog.depth == depth
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    kernel = "segmented_minmax" if grouped else "filter_agg"
    wrapper, plain = WRAPPERS[kernel]
    got = wrapper(cols, mask, program=prog, tiling=None)
    want = plain(cols, mask, program=prog)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if grouped:
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


def _compiled_block(K, A, fns, n, seed, dev):
    """Columns x, y (float64, with NaN, +-inf and -0.0) and a group id g
    that also falls outside [0, K), a mask, and a grouped program of A
    aggregates cycling through ``fns``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 100
    y = rng.normal(size=n)
    for v in (x, y):
        special = rng.random(n)
        v[special < 0.001] = np.nan
        v[(special >= 0.001) & (special < 0.002)] = np.inf
        v[(special >= 0.002) & (special < 0.003)] = -np.inf
        v[(special >= 0.003) & (special < 0.01)] = -0.0
    g = rng.integers(-2, K + 2, n).astype(np.int32)
    cols = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev),
            "g": torch.from_numpy(g).to(dev)}
    args = [_col("x"), {"t": "bin", "op": "*", "l": _col("x"),
                        "r": _col("y")}, _col("y")]
    aggs = [(fns[a % len(fns)], None if fns[a % len(fns)] == "count"
             else args[a % len(args)]) for a in range(A)]
    prog = compile_program([{"t": "cmp", "op": "<>", "l": _col("y"),
                             "r": _lit(0.5)}], aggs, group_cols=["g"],
                           strides=[1], n_groups=K)
    mask = torch.from_numpy(rng.random(n) < 0.95).to(dev)
    return cols, mask, prog


def _plain_on_cpu(cols, mask, prog):
    """The plain version on the CPU, whose min/max keep NaN as jnp does."""
    return smm.fused_groupby_minmax_plain({c: v.cpu() for c, v in
                                           cols.items()}, mask.cpu(),
                                          program=prog)


@pytest.mark.parametrize("K,A", [(16, 3), (13, 4)])
def test_register_tile_limit_matches_plain(session, K, A):
    """K·(A+1) at the register-tile limit (64: the tile in registers) and
    one past it (65: in shared memory), sums, counts, min and max."""
    dev = torch.device("cuda", 0)
    cols, mask, prog = _compiled_block(K, A, ["sum", "count", "min", "max"],
                                       1 << 20, K, dev)
    typed = for_columns(prog, cols)
    assert specialise.skeleton(typed) == (
        "group_regs" if K * (A + 1) <= specialise.REG_TILE
        else "group_smem")
    got = ops.fused_groupby_minmax(cols, mask, program=prog, tiling=None)
    want = _plain_on_cpu(cols, mask, prog)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("K", [3, 40])
def test_minmax_special_values_match_plain(session, K):
    """min/max over NaN, +-inf and -0.0, with group ids outside [0, K)
    (both grouped skeletons: 3 x 3 in registers, 40 x 3 in shared
    memory)."""
    dev = torch.device("cuda", 0)
    cols, mask, prog = _compiled_block(K, 2, ["min", "max"], 1 << 18,
                                       100 + K, dev)
    got = ops.fused_groupby_minmax(cols, mask, program=prog, tiling=None)
    want = _plain_on_cpu(cols, mask, prog)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, **TOL)


def _q1_block(session, n=1 << 18):
    s, _, lineitem = session
    m = _match(s, SQLS["q1"])
    dev = torch.device("cuda", 0)
    cols = {c: torch.from_numpy(lineitem[c][:n]).to(dev)
            for c in m.program.names}
    mask = torch.ones(len(next(iter(cols.values()))), dtype=torch.bool,
                      device=dev)
    return m, cols, mask


def test_q1_repeats_bit_for_bit(session):
    """The register tile has no atomics: two Q1 calls give equal bits."""
    m, cols, mask = _q1_block(session)
    a = ops.fused_groupby(cols, mask, program=m.program, tiling=m.tiling)
    b = ops.fused_groupby(cols, mask, program=m.program, tiling=m.tiling)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("query", sorted(SQLS))
def test_compiled_kernels_have_no_local_memory(session, query):
    s, _, lineitem = session
    m = _match(s, SQLS[query])
    dev = torch.device("cuda", 0)
    cols = {c: torch.from_numpy(lineitem[c][:1024]).to(dev)
            for c in m.program.names}
    k = specialise.kernel(for_columns(m.program, cols), dev)
    assert k.kind == ("filter_agg" if query == "q6" else "group_regs")
    assert k.local_bytes == 0, (query, k.regs, k.local_bytes)


def test_second_call_compiles_nothing(session):
    m, cols, mask = _q1_block(session, 4096)
    ops.fused_groupby(cols, mask, program=m.program, tiling=m.tiling)
    before = specialise.loaded()
    ops.fused_groupby(cols, mask, program=m.program, tiling=m.tiling)
    torch.cuda.synchronize()
    assert specialise.loaded() == before


@pytest.mark.parametrize("query", sorted(SQLS))
def test_query_on_the_card_equals_the_oracle(session, query):
    s, catalog, lineitem = session
    assert s.device.type == "cuda"
    res = s.sql(SQLS[query])
    stage0 = [p for p in res.stats.pipelines if p.kernel]
    assert stage0 and stage0[0].kernel_fragments == stage0[0].n_fragments
    lqp, _ = Binder(catalog).bind(parse(SQLS[query]))
    want = oracle.run(optimize(lqp), {"lineitem": lineitem})
    got = res.fetch(s.store)
    keys = sorted(want)
    assert sorted(got) == keys
    order_g = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    order_w = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64)[order_g],
                                   np.asarray(want[k], np.float64)[order_w],
                                   **TOL)


def _join_block(capacity: int, seed: int):
    """A probe block and a sorted build side of ``capacity`` rows each:
    masked rows on both sides, sentinel probe keys, int32 payload."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    keys = rng.permutation(2 * capacity)[:capacity].astype(np.int64)
    bmask = rng.random(capacity) < 0.8
    bk = torch.from_numpy(np.where(bmask, keys, np.iinfo(np.int64).max))
    sk, order = torch.sort(bk.to(dev), stable=True)
    pay = {"g": torch.from_numpy(rng.integers(0, 5, capacity).astype(
        np.int32)).to(dev)[order],
           "q": torch.from_numpy(rng.normal(size=capacity)).to(dev)[order]}
    pk = rng.integers(-3, 2 * capacity, capacity).astype(np.int64)
    pk[rng.random(capacity) < 0.05] = np.iinfo(np.int64).max
    probe = {"k": torch.from_numpy(pk).to(dev),
             "x": torch.from_numpy(rng.normal(size=capacity)).to(dev),
             "d": torch.from_numpy(rng.integers(0, 100, capacity).astype(
                 np.int32)).to(dev)}
    pmask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    return probe, pmask, sk, pay


def _col(n):
    return {"t": "col", "name": n}


def _lit(v):
    return {"t": "lit", "value": v, "kind": "num"}


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("n_groups", [0, 5])
def test_join_kernel_matches_plain(session, capacity, n_groups):
    probe, pmask, sk, pay = _join_block(capacity, seed=capacity + n_groups)
    aggs = [("sum", {"t": "bin", "op": "*", "l": _col("x"), "r": _col("q")}),
            ("count", None), ("min", _col("q")),
            ("max", {"t": "bin", "op": "/", "l": _col("d"), "r": _lit(7)})]
    prog = compile_program(
        [{"t": "cmp", "op": "<", "l": _col("d"), "r": _lit(80)}], aggs,
        group_cols=["g"] if n_groups else None,
        strides=[1] if n_groups else None, n_groups=n_groups)
    tiling = roofline.join_probe_tiling(n_cols=3, n_payload=2, n_aggs=4,
                                        n_groups=n_groups)
    before = ext.launches().get("join_probe_agg", 0)
    got = ops.fused_join_probe_agg(probe, pmask, sk, pay, probe_key="k",
                                   program=prog, tiling=tiling)
    want = jp.fused_join_probe_agg_plain(probe, pmask, sk, pay,
                                         probe_key="k", program=prog)
    torch.cuda.synchronize()
    assert ext.launches().get("join_probe_agg", 0) == before + 1
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if n_groups:
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
    np.testing.assert_allclose(g, w, **TOL)


# probe-side predicates on the probe block of _join_block (d in [0, 100)):
# one that rejects every row, one that accepts every row, a selective one;
# the residual reads the payload
_PROBE_PREDS = {
    "rejects all": [{"t": "cmp", "op": "<", "l": _col("d"), "r": _lit(0)}],
    "accepts all": [{"t": "cmp", "op": ">=", "l": _col("d"),
                     "r": _lit(0)}],
    "selective": [{"t": "cmp", "op": "<", "l": _col("d"), "r": _lit(7)}],
    "residual only": [],
}


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("n_groups", [0, 5])
@pytest.mark.parametrize("probe", sorted(_PROBE_PREDS))
def test_join_kernel_probe_predicate_matches_plain(session, capacity,
                                                   n_groups, probe):
    """The probe-predicate slot: the kernel runs it before the key search
    (none of a rejected row's key, search or payload is read), and the
    result equals the plain version's, where the slot is applied after
    the search."""
    probe_cols, pmask, sk, pay = _join_block(capacity,
                                             seed=capacity + n_groups + 7)
    aggs = [("sum", {"t": "bin", "op": "*", "l": _col("x"), "r": _col("q")}),
            ("count", None), ("max", _col("q"))]
    prog = compile_program(
        [{"t": "cmp", "op": ">", "l": _col("q"), "r": _lit(-0.5)}], aggs,
        group_cols=["g"] if n_groups else None,
        strides=[1] if n_groups else None, n_groups=n_groups,
        probe_preds=_PROBE_PREDS[probe])
    tiling = roofline.join_probe_tiling(n_cols=3, n_payload=2, n_aggs=3,
                                        n_groups=n_groups)
    before = ext.launches().get("join_probe_agg", 0)
    got = ops.fused_join_probe_agg(probe_cols, pmask, sk, pay,
                                   probe_key="k", program=prog,
                                   tiling=tiling)
    want = jp.fused_join_probe_agg_plain(probe_cols, pmask, sk, pay,
                                         probe_key="k", program=prog)
    torch.cuda.synchronize()
    assert ext.launches().get("join_probe_agg", 0) == before + 1
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if n_groups:
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
        assert (g[:, -1].sum() == 0) == (probe == "rejects all")
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("key_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("capacity", [1, 7, 1000, 1024, 1 << 16])
@pytest.mark.parametrize("bits", [1 << 10, 1 << 20, 1 << 21, 1 << 22])
def test_bloom_kernel_matches_plain(session, capacity, bits, key_dtype):
    """The kernel against the plain version and the host probe, lane for
    lane: random masks, an all-masked block, a mask whose tail is all
    padding (whole chunks of the vector path skip their keys), a view at
    storage offset 1 (the scalar loop), capacities that are not a
    multiple of the chunk and k = 3 as well as BLOOM_K = 6; one
    counted launch a call."""
    rng = np.random.default_rng(bits + capacity)
    dev = torch.device("cuda", 0)
    members = rng.integers(0, 1 << 20, 5000)
    host_words = bloom.bloom_build(members.astype(np.uint32), bits)
    words = bloom.words_tensor(host_words, dev)
    n_members = min(100, capacity)
    keys_np = np.concatenate([members[:n_members], rng.integers(
        -(1 << 40), 1 << 40, capacity + 1 - n_members)]).astype(key_dtype)
    full = torch.from_numpy(keys_np).to(dev)
    keys = full[:capacity]
    tail = np.zeros(capacity, bool)
    tail[:capacity // 3] = True
    masks = {"random": rng.random(capacity) < 0.9,
             "all masked": np.zeros(capacity, bool), "padding tail": tail}
    for label, m in masks.items():
        mask = torch.from_numpy(m).to(dev)
        got = _launched("bloom_filter", lambda: ops.fused_bloom_filter(
            keys, mask, words=words, bits=bits, k=6,
            tiling=None))
        want = bloom.fused_bloom_filter_plain(keys, mask, words=words,
                                              bits=bits, k=6)
        assert torch.equal(got, want), label
        host = bloom.bloom_probe_np(keys_np[:capacity].astype(np.uint32),
                                    host_words, bits) & m
        np.testing.assert_array_equal(got.cpu().numpy(), host, label)
    # a view at storage offset 1: key and mask off their vector alignment
    mfull = torch.from_numpy(rng.random(capacity + 1) < 0.9).to(dev)
    kv, mv = full[1:], mfull[1:]
    assert not bloom.vector_layout(kv.data_ptr(), kv.element_size(),
                                   mv.data_ptr(), 0, capacity)[0]
    got = _launched("bloom_filter", lambda: ops.fused_bloom_filter(
        kv, mv, words=words, bits=bits, k=6,
        tiling=None))
    assert torch.equal(got, bloom.fused_bloom_filter_plain(
        kv, mv, words=words, bits=bits, k=6))
    # k = 3: a second wave of two reads
    mask = torch.from_numpy(masks["random"]).to(dev)
    got = _launched("bloom_filter", lambda: ops.fused_bloom_filter(
        keys, mask, words=words, bits=bits, k=3,
        tiling=None))
    assert torch.equal(got, bloom.fused_bloom_filter_plain(
        keys, mask, words=words, bits=bits, k=3))


# the semi-join tests' selective join, grouped by a dictionary-coded
# column so that every stage runs a ported kernel arm
SELECTIVE_JOIN = (
    "select o_orderpriority, sum(l_extendedprice) as rev "
    "from lineitem, orders "
    "where l_orderkey = o_orderkey and o_totalprice > 500000 "
    "group by o_orderpriority")


@pytest.mark.parametrize("query", ["q12", "q14", "q19", "semijoin"])
def test_join_query_on_the_card_equals_the_oracle(session, query):
    s, catalog, _ = session
    from repro_torch.core.engine import QueryEngine
    sql = SELECTIVE_JOIN if query == "semijoin" else QUERIES[query]
    if query == "semijoin":     # repartition join, filter forced on
        cfg = CoordinatorConfig(
            planner=PlannerConfig(broadcast_threshold_bytes=1,
                                  exchange_partitions=4),
            use_result_cache=False, pipelined=False, adaptive=False)
        eng = QueryEngine(s.store, catalog, platform=s.platform,
                          config=cfg, handler=s.handler)
        plan = eng.plan_sql(sql)
        (probe,) = [p for p in plan.pipelines.values()
                    if p.params.semijoin]
        probe.params.semijoin["enabled"] = True
        before = ext.launches().get("bloom_filter", 0)
        res = eng.execute_plan(plan)
        assert ext.launches().get("bloom_filter", 0) > before
        pr = next(r for r in res.stats.pipelines if r.pid == probe.pid)
        assert pr.kernel_fragments == pr.n_fragments
        assert pr.semijoin_killed > 0
        assert not any("not yet ported" in p.kernel_miss_reason
                       for p in res.stats.pipelines)
    else:
        res = s.sql(sql)
        (join,) = [p for p in res.stats.pipelines if p.kernel]
        assert join.kernel == "join_probe_agg"
        assert join.kernel_fragments == join.n_fragments
    lqp, _ = Binder(catalog).bind(parse(sql))
    want = oracle.run(optimize(lqp), _tables(s, catalog))
    got = res.fetch(s.store)
    keys = sorted(want)
    assert sorted(got) == keys
    order_g = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    order_w = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64)[order_g],
                                   np.asarray(want[k], np.float64)[order_w],
                                   **TOL)


def _sort_block(capacity: int, seed: int, n_keys: int):
    """Int64 keys with ties and a few INT64_MAX keys, f64 values with NaN
    and inf in masked rows, a mask."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    mask = rng.random(capacity) < 0.8
    keys = []
    for _ in range(n_keys):
        k = rng.integers(0, max(capacity // 8, 2), capacity)
        k[rng.random(capacity) < 0.01] = np.iinfo(np.int64).max
        keys.append(torch.from_numpy(k.astype(np.int64)).to(dev))
    v = rng.normal(size=capacity)
    v[~mask & (rng.random(capacity) < 0.3)] = np.nan
    v[~mask & (rng.random(capacity) < 0.3)] = np.inf
    return keys, torch.from_numpy(v).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("n_keys", [1, 2])
def test_sort_agg_kernel_matches_plain(session, capacity, n_keys):
    keys, v, mask = _sort_block(capacity, capacity + n_keys, n_keys)
    fns = ["sum", "count", "min", "max"]
    values = [v, None, v, v]
    tiling = roofline.sort_tiling("sort_agg", n_keys=n_keys)
    before = ext.launches().get("sort_agg", 0)
    got = ops.fused_sort_agg(keys, values, fns, mask, tiling=tiling)
    want = sa.fused_sort_agg_plain(keys, values, fns, mask)
    torch.cuda.synchronize()
    assert ext.launches().get("sort_agg", 0) == before + 1
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 1
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   equal_nan=True, **TOL)


@pytest.mark.parametrize("capacity", [1024, 1 << 16])
@pytest.mark.parametrize("limit", [10, 1 << 17])
def test_topk_kernel_matches_plain(session, capacity, limit):
    rng = np.random.default_rng(capacity + limit)
    dev = torch.device("cuda", 0)
    rev = rng.normal(size=capacity).round(1)
    rev[::7] = -0.0                         # ties of -0.0 with +0.0
    cols = {"rev": torch.from_numpy(rev).to(dev),
            "d": torch.from_numpy(rng.integers(0, 5, capacity).astype(
                np.int32)).to(dev),
            "k": torch.from_numpy(rng.integers(0, 1 << 40, capacity)).to(
                dev),
            "b": torch.from_numpy(rng.random(capacity) < 0.5).to(dev)}
    mask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    sort_keys = [("rev", True), ("d", False)]
    tiling = roofline.sort_tiling("topk", n_keys=2)
    before = ext.launches().get("topk", 0)
    got, gmask = ops.fused_topk(cols, mask, sort_keys=sort_keys,
                                limit=limit, tiling=tiling)
    want, wmask = tk.fused_topk_plain(cols, mask, sort_keys=sort_keys,
                                      limit=limit)
    torch.cuda.synchronize()
    assert ext.launches().get("topk", 0) == before + 1
    assert list(got) == list(want) and torch.equal(gmask, wmask)
    for c in want:
        assert got[c].dtype == want[c].dtype
        if got[c].is_floating_point():      # bit for bit, -0.0 included
            assert torch.equal(got[c].view(torch.int64),
                               want[c].view(torch.int64))
        else:
            assert torch.equal(got[c], want[c])


def _edge_keys(kind: str, capacity: int, rng) -> np.ndarray:
    """A key column for the radix sort's edge cases: every row equal (no
    live digit), the int64 extremes, or ties."""
    if kind == "equal":
        return np.full(capacity, -3, np.int64)
    if kind == "extremes":
        return rng.choice(np.array([np.iinfo(np.int64).min,
                                    np.iinfo(np.int64).max, -1, 0, 1],
                                   np.int64), capacity)
    return rng.integers(-5, max(capacity // 4, 2), capacity).astype(np.int64)


@pytest.mark.parametrize("capacity,kinds", [
    (1, ["ties"]), (1 << 12, ["equal"]), (1 << 12, ["extremes"]),
    (1 << 13, ["ties", "extremes", "ties"]), (1 << 13, ["equal", "ties"]),
    (1 << 16, ["extremes", "equal", "ties"]),
])
def test_sort_agg_radix_edge_cases_match_plain(card, capacity, kinds):
    """The radix sort under sort_agg lane for lane against the plain
    version: one row, one and two radix blocks (2^12, 2^13), all-equal
    keys (no live pass), INT64_MIN / INT64_MAX keys, 3 key lanes."""
    rng = np.random.default_rng(capacity + len(kinds))
    dev = torch.device("cuda", 0)
    keys = [torch.from_numpy(_edge_keys(k, capacity, rng)).to(dev)
            for k in kinds]
    v = torch.from_numpy(rng.normal(size=capacity)).to(dev)
    mask = torch.from_numpy(rng.random(capacity) < 0.8).to(dev)
    fns = ["sum", "count", "min", "max"]
    values = [v, None, v, v]
    tiling = roofline.sort_tiling("sort_agg", n_keys=len(keys))
    got = _launched("sort_agg", lambda: ops.fused_sort_agg(
        keys, values, fns, mask, tiling=tiling))
    want = sa.fused_sort_agg_plain(keys, values, fns, mask)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   equal_nan=True, **TOL)


@pytest.mark.parametrize("capacity", [1, 1 << 12, 1 << 13, 1 << 15])
@pytest.mark.parametrize("descending", [False, True])
def test_topk_radix_float_keys_match_plain(card, capacity, descending):
    """f64 sort keys with -0.0, NaN and ±inf, ascending and descending,
    over int64 extremes and all-equal columns, lane for lane (floats bit
    for bit) against the plain version: on the one-launch cluster path up
    to 2^13 rows, on the radix sort at 2^15."""
    rng = np.random.default_rng(capacity + descending)
    dev = torch.device("cuda", 0)
    f = rng.normal(size=capacity).round(1)
    f = np.where(rng.random(capacity) < 0.4, rng.choice(np.array(
        [-0.0, 0.0, np.nan, np.inf, -np.inf]), capacity), f)
    cols = {"f": torch.from_numpy(f).to(dev),
            "i": torch.from_numpy(_edge_keys("extremes", capacity, rng)).to(
                dev),
            "e": torch.from_numpy(_edge_keys("equal", capacity, rng)).to(
                dev)}
    mask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    for sort_keys in ([("f", descending)], [("e", descending)],
                      [("i", not descending), ("f", descending),
                       ("e", False)]):
        got, gmask = _launched("topk", lambda: ops.fused_topk(
            cols, mask, sort_keys=sort_keys, limit=7,
            tiling=roofline.sort_tiling("topk", n_keys=len(sort_keys))))
        want, wmask = tk.fused_topk_plain(cols, mask, sort_keys=sort_keys,
                                          limit=7)
        assert torch.equal(gmask, wmask)
        for c in want:
            g, w = got[c], want[c]
            if g.is_floating_point():
                g, w = g.view(torch.int64), w.view(torch.int64)
            assert torch.equal(g, w), (sort_keys, c)


def _topk_edge_cases(capacity: int, rng, dev):
    """(label, columns, mask, limit) of the top-k's edge cases at one
    capacity, sorted by ``rev`` descending then ``d``: all ties, -0.0
    against +0.0 under descending, NaN and inf in masked rows, every row
    masked, a limit at or past the valid rows."""
    base = {"rev": torch.from_numpy(rng.normal(size=capacity).round(1)).to(
                dev),
            "d": torch.from_numpy(rng.integers(0, 5, capacity).astype(
                np.int32)).to(dev),
            "k": torch.from_numpy(rng.integers(0, 1 << 40, capacity)).to(
                dev)}
    mask = torch.from_numpy(rng.random(capacity) < 0.9).to(dev)
    idx = torch.arange(capacity, device=dev)
    ties = dict(base, rev=torch.full((capacity,), 3.5, dtype=torch.float64,
                                     device=dev),
                d=torch.full((capacity,), 7, dtype=torch.int32, device=dev))
    zeros = dict(base, rev=torch.where(idx % 2 == 0, 0.0, -0.0).to(
        torch.float64))
    nan = dict(base, rev=torch.where(mask, base["rev"], float("nan")))
    nan["rev"][~mask & (idx % 3 == 0)] = float("inf")
    return [("ties", ties, mask, 10), ("-0.0/+0.0 desc", zeros, mask, 100),
            ("NaN and inf masked", nan, mask, 10),
            ("all masked", base, torch.zeros_like(mask), 10),
            ("limit >= valid", base, mask, capacity)]


def _assert_topk_equal(got, want, ctx):
    (gcols, gmask), (wcols, wmask) = got, want
    assert list(gcols) == list(wcols) and torch.equal(gmask, wmask), ctx
    for c in wcols:
        g, w = gcols[c], wcols[c]
        assert g.dtype == w.dtype, (ctx, c)
        if g.is_floating_point():           # bit for bit, -0.0 and NaN too
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), (ctx, c)


@pytest.mark.parametrize("capacity", [1, 1 << 13, 1 << 14, 1 << 15])
def test_topk_on_both_sides_of_the_cluster_cap_matches_plain(card,
                                                             capacity):
    """The one-launch cluster path up to roofline.topk_block_rows (2^14
    with two keys: 16 CTAs; 2^13: 8; one row: 1), the radix path one power
    of two past it: every edge case lane for lane, masked lanes included,
    against the plain version."""
    rng = np.random.default_rng(capacity)
    sort_keys = [("rev", True), ("d", False)]
    want_path = tk.CLUSTER if capacity <= 1 << 14 else tk.RADIX
    assert tk.path(capacity, len(sort_keys)) == want_path
    tiling = roofline.sort_tiling("topk", n_keys=2)
    for label, cols, mask, limit in _topk_edge_cases(capacity, rng, card):
        got = _launched("topk", lambda: ops.fused_topk(
            cols, mask, sort_keys=sort_keys, limit=limit, tiling=tiling))
        _assert_topk_equal(got, tk.fused_topk_plain(
            cols, mask, sort_keys=sort_keys, limit=limit), label)


def test_topk_cluster_path_gathers_more_than_one_launch_of_columns(card):
    """40 columns of every width on the cluster path: the kernel gathers
    the first 32, a gather launch the rest, by the positions it wrote."""
    rng = np.random.default_rng(40)
    n = 1 << 12
    dtypes = [np.float64, np.int64, np.float32, np.int32, np.int16,
              np.int8, np.bool_]
    cols = {f"c{j}": torch.from_numpy(
        (rng.integers(-50, 50, n)).astype(dtypes[j % len(dtypes)])).to(card)
        for j in range(40)}
    mask = torch.from_numpy(rng.random(n) < 0.7).to(card)
    sort_keys = [("c1", True), ("c0", False)]
    got = _launched("topk", lambda: ops.fused_topk(
        cols, mask, sort_keys=sort_keys, limit=25,
        tiling=roofline.sort_tiling("topk", n_keys=2)))
    _assert_topk_equal(got, tk.fused_topk_plain(
        cols, mask, sort_keys=sort_keys, limit=25), "40 columns")


def test_topk_at_q3s_capacity_is_one_cuda_launch(card):
    """A call at 2^14 rows and two keys (TPC-H Q3's final at SF 1) runs
    one CUDA kernel, once (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(14)
    n = 1 << 14
    cols = {"rev": torch.from_numpy(rng.normal(size=n) * 1e5).to(card),
            "d": torch.from_numpy(rng.integers(8000, 10000, n).astype(
                np.int32)).to(card),
            "k": torch.from_numpy(rng.integers(0, 1 << 40, n)).to(card)}
    mask = torch.from_numpy(rng.random(n) < 0.7).to(card)
    call = lambda: ops.fused_topk(  # noqa: E731
        cols, mask, sort_keys=[("rev", True), ("d", False)], limit=10,
        tiling=roofline.sort_tiling("topk", n_keys=2))
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert [e.name.split("(")[0] for e in kernels] == \
        ["sortnet::topk_block_kernel"], [e.name for e in kernels]


SORTAGG_SQL = ("select l_orderkey, sum(l_quantity) as s, count(*) as c "
               "from lineitem group by l_orderkey order by l_orderkey")


@pytest.mark.parametrize("query", ["sortagg", "q3"])
def test_sort_query_on_the_card_equals_the_oracle(session, query):
    """The GROUP BY l_orderkey's stage 0 runs sort_agg; Q3's join stage
    runs sort_agg over its joins and its final runs topk under the
    benchmark suites' planner (at SF 0.01 the default planner folds the
    final into the merge stage)."""
    s, catalog, _ = session
    from repro_torch.core.engine import QueryEngine
    kernels = {"sortagg": ["sort_agg"], "q3": ["sort_agg", "topk"]}[query]
    sql = SORTAGG_SQL if query == "sortagg" else QUERIES["q3"]
    cfg = CoordinatorConfig(planner=PlannerConfig(
        bytes_per_worker=500_000, broadcast_threshold_bytes=250_000,
        exchange_partitions=4))
    eng = QueryEngine(s.store, catalog, platform=s.platform, config=cfg,
                      handler=s.handler)
    before = ext.launches()
    res = eng.execute_plan(eng.plan_sql(sql))
    ran = [p for p in res.stats.pipelines if p.kernel]
    assert [p.kernel for p in ran] == kernels
    for p in ran:
        assert p.kernel_fragments == p.n_fragments
        assert ext.launches().get(p.kernel, 0) >= \
            before.get(p.kernel, 0) + p.n_fragments
    assert not any("not yet ported" in r.kernel_miss_reason
                   for r in res.stats.pipelines)
    lqp, _ = Binder(catalog).bind(parse(sql))
    want = oracle.run(optimize(lqp), _tables(s, catalog))
    got = res.fetch(s.store)
    keys = sorted(want)
    assert sorted(got) == keys
    order_g = np.lexsort([np.asarray(got[k], np.float64) for k in keys])
    order_w = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64)[order_g],
                                   np.asarray(want[k], np.float64)[order_w],
                                   **TOL)


# -- the kernels no query reaches: Q6 and grouped sums at fixed layout, the
# model kernels (flash attention, the SSD scan)

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have "
                    "no CPU mode")
    return torch.device("cuda", 0)


def _launched(name, fn):
    before = ext.launches().get(name, 0)
    out = fn()
    torch.cuda.synchronize()
    assert ext.launches().get(name, 0) == before + 1
    return out


@pytest.mark.parametrize("n", [1, 3, 5, 1000, 1 << 20])
def test_filter_agg_q6_kernel_matches_plain(card, n):
    """The kernel against the plain version: aligned columns (whole
    groups of four and a ragged tail), views at storage offset 1 (the
    scalar loop), and a second call's bits; one counted launch a call.
    The first row passes, so every count is at least 1."""
    rng = np.random.default_rng(n)
    m = n + 1
    ship = rng.integers(8000, 10000, m).astype(np.int32)
    disc = (rng.integers(0, 11, m) / 100).astype(np.float32)
    qty = rng.integers(1, 51, m).astype(np.float32)
    price = rng.random(m).astype(np.float32) * 1e4
    ship[:2], disc[:2], qty[:2] = 9000, 0.06, 10
    full = [torch.from_numpy(a).to(card) for a in (ship, disc, qty, price)]
    bounds = dict(date_lo=8500, date_hi=9500, disc_lo=0.05, disc_hi=0.07,
                  qty_hi=24.0)
    for label, cols in (("aligned", [c[:n] for c in full]),
                        ("offset 1", [c[1:] for c in full])):
        assert fa.q6_layout([c.data_ptr() for c in cols], n)[0] \
            == (label == "aligned")
        got = _launched("filter_agg_q6", lambda: ops.filter_agg(
            *cols, **bounds))
        want = fa.filter_agg_plain(*cols, **bounds)
        assert got.dtype == torch.float32 and got.shape == (2,)
        assert float(got[1]) == float(want[1]) > 0, label
        np.testing.assert_allclose(float(got[0]), float(want[0]),
                                   rtol=1e-4, err_msg=label)
        again = _launched("filter_agg_q6", lambda: ops.filter_agg(
            *cols, **bounds))
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))


def test_filter_agg_q6_streams_keep_their_own_ticket(card):
    """Calls on two streams at once, each folded by its last CTA behind
    its own stream's counter: each equals the plain version."""
    rng = np.random.default_rng(7)
    bounds = dict(date_lo=8500, date_hi=9500, disc_lo=0.05, disc_hi=0.07,
                  qty_hi=24.0)
    sets = []
    for n in (1 << 20, 300_001):
        sets.append([torch.from_numpy(a).to(card) for a in (
            rng.integers(8000, 10000, n).astype(np.int32),
            (rng.integers(0, 11, n) / 100).astype(np.float32),
            rng.integers(1, 51, n).astype(np.float32),
            rng.random(n).astype(np.float32) * 1e4)])
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in sets]
    outs = []
    for _ in range(3):
        for st, cols in zip(streams, sets):
            with torch.cuda.stream(st):
                outs.append((ops.filter_agg(*cols, **bounds), cols))
    torch.cuda.synchronize()
    for got, cols in outs:
        want = fa.filter_agg_plain(*cols, **bounds)
        assert float(got[1]) == float(want[1]) > 0
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)


@pytest.mark.parametrize("n,K,A", [(5000, 6, 5), (1 << 20, 120, 5),
                                   (70_001, 1, 1), (70_001, 6, 5),
                                   (70_001, 8, 8), (70_001, 13, 5),
                                   (70_001, 120, 5)])
def test_groupby_onehot_kernel_matches_plain(card, n, K, A):
    rng = np.random.default_rng(n + K)
    gid = rng.integers(-1, K + 1, n).astype(np.int32)   # -1 and K: no group
    gid = torch.from_numpy(gid).to(card)
    vals = torch.from_numpy(rng.standard_normal((n, A)).astype(
        np.float32)).to(card)
    got = _launched("groupby_onehot", lambda: ops.groupby_onehot(
        gid, vals, n_groups=K))
    want = go.groupby_onehot_plain(gid, vals, n_groups=K)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("K,A", [(6, 5), (8, 8)])
def test_groupby_onehot_register_path_repeats_bit_for_bit(card, K, A):
    """K·A <= 64 runs the register tile, whose sums take a fixed order:
    two calls give equal bits."""
    assert go.onehot_layout(K, A)[0] == "registers"
    rng = np.random.default_rng(K * A)
    n = 1 << 21
    gid = torch.from_numpy(rng.integers(-1, K + 1, n).astype(
        np.int32)).to(card)
    vals = torch.from_numpy(rng.standard_normal((n, A)).astype(
        np.float32) * 100).to(card)
    a = ops.groupby_onehot(gid, vals, n_groups=K)
    b = ops.groupby_onehot(gid, vals, n_groups=K)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,hd,heads,kv_heads,causal,window", [
    (200, 64, 8, 2, True, 0), (256, 128, 2, 2, False, 0),
    (64, 64, 4, 1, True, 0), (300, 64, 4, 4, True, 100),
])
def test_flash_attention_kernel_matches_plain(card, dtype, S, hd, heads,
                                              kv_heads, causal, window):
    from repro_torch.kernels import flash_attention as fl
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((h, S, hd)).astype(
        np.float32)).to(card, dtype) for h in (heads, kv_heads, kv_heads))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    want = fl.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        # the kernel's float32 math rounded once: within half a bf16 ulp
        # (2^-8 of the value) of the float32 result on the same inputs
        exact = fl.flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   exact.cpu().numpy(), atol=2e-5,
                                   rtol=2.0 ** -8)


@pytest.mark.parametrize("S,hd,heads,kv_heads,causal,window", [
    (256, 128, 4, 2, True, 0), (333, 128, 2, 2, True, 0),
    (200, 64, 8, 2, True, 0), (40, 64, 4, 2, True, 0),
    (50, 128, 2, 1, False, 0), (1024, 64, 8, 8, True, 0),
    (777, 64, 5, 1, True, 256), (640, 128, 4, 2, True, 100),
    (1000, 64, 8, 2, False, 0), (513, 128, 4, 4, False, 0),
])
def test_flash_attention_bf16_tensor_cores_within_half_ulp(
        card, S, hd, heads, kv_heads, causal, window):
    """The bf16 tensor-core kernel (split-bf16 P) against the float32
    plain result on the same bf16 inputs at chip_smoke.py's check (rtol
    2^-8, atol 2e-5): head dims 64 and 128, ragged S, S below one tile,
    group 1, windows and non-causal."""
    from repro_torch.kernels import flash_attention as fl
    rng = np.random.default_rng(S * hd + heads)
    q, k, v = (torch.from_numpy(rng.standard_normal((h, S, hd)).astype(
        np.float32)).to(card, torch.bfloat16)
        for h in (heads, kv_heads, kv_heads))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    exact = fl.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exact.cpu().numpy(), atol=2e-5,
                               rtol=2.0 ** -8)


@pytest.mark.parametrize("draw", ["unit", "mamba2"])
@pytest.mark.parametrize("b,S,H,N,chunk", [(2, 1000, 3, 128, 256),
                                           (1, 256, 4, 16, 64),
                                           (1, 100, 2, 32, 256),
                                           # one chunk, S below a strip
                                           (2, 40, 3, 64, 256),
                                           # chunk 1024: four key blocks
                                           (1, 2048, 2, 128, 1024),
                                           # S not a multiple of 1024
                                           (2, 1500, 3, 64, 1024),
                                           # one head: b·H below a group
                                           (1, 700, 1, 16, 128),
                                           # chunks not a multiple of 64
                                           (2, 333, 5, 32, 100)])
def test_ssd_scan_kernel_matches_plain(card, b, S, H, N, chunk, draw):
    """``unit``: the reference's test draw (dt near 0.8, A near -1, a
    memory of a few tokens); ``mamba2``: mamba2-130m's dynamics (dt
    log-uniform in [1e-3, 0.1], A in [-16, -1]), whose long memory
    reaches the off-diagonal tiles and the state carried across chunks."""
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(S + N)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(card)
    x = f32(rng.standard_normal((b, S, H, 64)) * 0.5)
    if draw == "mamba2":
        dt = f32(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, S, H))))
        A_log = f32(np.log(rng.uniform(1.0, 16.0, H)))
    else:
        dt = f32(np.log1p(np.exp(rng.standard_normal((b, S, H)))))
        A_log = f32(rng.standard_normal(H) * 0.3)
    B = f32(rng.standard_normal((b, S, N)) * 0.5)
    C = f32(rng.standard_normal((b, S, N)) * 0.5)
    got = _launched("ssd_scan", lambda: ops.ssd_scan(x, dt, A_log, B, C,
                                                     chunk=chunk))
    want = ssd.ssd_scan_plain(x, dt, A_log, B, C, chunk=chunk)
    err = (got - want).abs().max().item()
    assert err / (want.abs().max().item() + 1e-9) < 5e-5


def test_ssd_scan_runs_on_the_tensor_cores(card):
    """The SSD library's SASS holds TF32 tensor-core instructions."""
    assert ext.sass("ssd_scan").count("HMMA") > 0


def test_model_kernel_wrappers_refuse_what_the_kernels_do_not_take(card):
    n = 64
    i32 = torch.zeros(n, dtype=torch.int32, device=card)
    f32 = torch.zeros(n, dtype=torch.float32, device=card)
    with pytest.raises(ValueError):          # a float64 price column
        ops.filter_agg(i32, f32, f32, f32.double(), date_lo=0, date_hi=1,
                       disc_lo=0.0, disc_hi=1.0, qty_hi=1.0)
    with pytest.raises(ValueError):          # int64 group ids
        ops.groupby_onehot(i32.long(), f32[:, None], n_groups=4)
    with pytest.raises(ValueError):          # non-contiguous values
        ops.groupby_onehot(i32, torch.zeros((2, n), device=card).t(),
                           n_groups=4)
    q = torch.zeros((2, 16, 64), device=card)
    with pytest.raises(ValueError):          # float16
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):          # non-contiguous k
        ops.flash_attention(q, q.transpose(0, 1).contiguous().transpose(
            0, 1), q)
    with pytest.raises(ValueError):          # head dim 32
        ops.flash_attention(q[..., :32].contiguous(),
                            q[..., :32].contiguous(),
                            q[..., :32].contiguous())
    x = torch.zeros((1, 16, 2, 64), device=card)
    dt = torch.zeros((1, 16, 2), device=card)
    bc = torch.zeros((1, 16, 16), device=card)
    with pytest.raises(ValueError):          # float64 x
        ops.ssd_scan(x.double(), dt, dt[0, 0], bc, bc)
    with pytest.raises(ValueError):          # P = 32
        ops.ssd_scan(x[..., :32].contiguous(), dt, dt[0, 0], bc, bc)


# -- the service tier on the card

def test_service_on_the_card_equals_the_cpu_port(session):
    """Two tenants' Q6, Q12 and Q3 through a ``QueryService`` over a card
    session (result cache off, so every request runs its fragments; the
    benchmark suites' planner, so Q3's final runs the top-k kernel): each
    request SUCCEEDED, each kernel launched for both tenants, and the rows
    equal the port's on the CPU over the same store. Pipelined mode: with
    the cache off the two tenants' runs of one statement are live at once,
    and each execution names its results and partial streams for itself
    (``QueryEngine._execution_names``), so fleets sized apart do not mix
    each other's objects (``probes/service_race.py``,
    ``tests/test_torch_race.py``)."""
    from repro_torch.service import QueryService, TenantConfig
    s, catalog, _ = session
    planner = PlannerConfig(bytes_per_worker=500_000,
                            broadcast_threshold_bytes=250_000,
                            exchange_partitions=4)
    card_s = connect(s.store, catalog, quota=16, max_concurrent_queries=4,
                     config=CoordinatorConfig(planner=planner,
                                              use_result_cache=False,
                                              pipelined=True))
    cpu_s = connect(s.store, catalog, quota=16, device="cpu",
                    config=CoordinatorConfig(planner=planner,
                                             use_result_cache=False,
                                             pipelined=False))
    kernels = {"q6": "filter_agg", "q12": "join_probe_agg", "q3": "topk"}
    try:
        assert card_s.device.type == "cuda"
        before = ext.launches()
        with QueryService(card_s, tenants=(
                TenantConfig("gold", weight=3.0, deadline_s=30.0),
                TenantConfig("bronze", budget_cents=100.0))) as svc:
            handles = {(t, q): svc.submit(QUERIES[q], tenant=t)
                       for t in ("gold", "bronze") for q in kernels}
            got = {k: h.fetch(timeout=300) for k, h in handles.items()}
            status = {k: h.entry().status.value for k, h in handles.items()}
        after = ext.launches()
        assert set(status.values()) == {"SUCCEEDED"}, status
        for name in kernels.values():
            assert after.get(name, 0) - before.get(name, 0) >= 2, name
        for q in kernels:
            want = cpu_s.sql(QUERIES[q]).fetch(s.store)
            keys = sorted(want)
            ow = np.lexsort([np.asarray(want[k], np.float64) for k in keys])
            for t in ("gold", "bronze"):
                cols = got[(t, q)]
                assert sorted(cols) == keys
                og = np.lexsort([np.asarray(cols[k], np.float64)
                                 for k in keys])
                for k in keys:
                    np.testing.assert_allclose(
                        np.asarray(cols[k], np.float64)[og],
                        np.asarray(want[k], np.float64)[ow], **TOL)
    finally:
        card_s.close()
        cpu_s.close()


# -- the model stack on the card

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.parametrize("arch", ["granite-3-2b", "hymba-1.5b",
                                  "granite-moe-1b-a400m"])
def test_model_serving_on_the_card_equals_the_cpu_port(arch):
    """A reduced config's prefill and two decode steps on the card, in
    float32 with TF32 off, against the port on the CPU on the same
    parameters: logits and every cache tensor within 1e-4 of the largest
    CPU value, the same greedy tokens. The model path launches none of
    the port's kernels (the reference's calls none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs import get_reduced
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.models.model import init_params
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = get_reduced(arch)
        card = torch.device("cuda", 0)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 50)).astype(np.int32))
        runs = {}
        before = ext.launches()
        for dev in (torch.device("cpu"), card):
            p, tok = _to(params, dev), tokens.to(dev)
            out = {}
            out["last"], cache = prefill(cfg, p, tok[:, :48], max_len=50,
                                         compute_dtype=torch.float32)
            out["cache0"] = cache
            for i in (1, 2):
                out[f"dec{i}"], cache = decode_step(
                    cfg, p, cache, tok[:, 47 + i],
                    compute_dtype=torch.float32)
                out[f"cache{i}"] = cache
            runs[dev.type] = _to(out, torch.device("cpu"))
        assert ext.launches() == before
        cpu, got = runs["cpu"], runs["cuda"]
        for name in ("last", "dec1", "dec2"):
            scale = float(cpu[name].abs().max())
            assert float((got[name] - cpu[name]).abs().max()) \
                <= 1e-4 * scale, (arch, name)
            assert torch.equal(got[name].argmax(-1), cpu[name].argmax(-1))
        for step in ("cache0", "cache1", "cache2"):
            assert sorted(got[step]) == sorted(cpu[step])
            for key, want in cpu[step].items():
                if key == "pos":
                    assert int(got[step][key]) == int(want)
                    continue
                scale = float(want.abs().max())
                assert float((got[step][key] - want).abs().max()) \
                    <= 1e-4 * scale, (arch, step, key)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


# -- the training half on the card

def _tf32_off():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def _copy(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _rel_close(got, want, rel, ctx):
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (ctx, err, scale)


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_train_step_on_the_card_equals_the_cpu_port(arch):
    """One train step of a reduced config on the card (float32, TF32 off)
    against the port on the CPU from the same parameters and batch: loss
    and grad_norm within 1e-5 relative, every gradient leaf within 1e-4
    of its largest CPU value; no kernel launches on the path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch import tree
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import make_trainer, synthetic_batch
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import make_grad_fn
    old = _tf32_off()
    try:
        cfg = get_reduced(arch)
        card = torch.device("cuda", 0)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        runs = {}
        before = ext.launches()
        for dev in (torch.device("cpu"), card):
            batch = synthetic_batch(cfg, 0, 4, 32, dev)
            loss, grads = make_grad_fn(cfg, compute_dtype=torch.float32)(
                _copy(params, dev), batch)
            opt, step = make_trainer(cfg, steps=5)
            p = _copy(params, dev)           # the step updates in place
            _, state, m = step(p, opt.init(p), batch)
            runs[dev.type] = (float(loss), [g.cpu() for g in grads],
                              float(m["loss"]), float(m["grad_norm"]))
            assert int(state["step"]) == 1
        assert ext.launches() == before
        cpu, got = runs["cpu"], runs["cuda"]
        for i in (0, 2, 3):
            assert abs(got[i] - cpu[i]) <= 1e-5 * abs(cpu[i]), (arch, i)
        names = [n for n, _ in tree.flatten_with_names(params)]
        for name, g, w in zip(names, got[1], cpu[1]):
            _rel_close(g, w, 1e-4, (arch, name))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_adamw_on_the_card_equals_the_cpu(state_dtype):
    """Three AdamW updates on the card against the CPU, same gradients:
    parameters and moments within 1e-6 of their largest CPU value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch import tree
    from repro_torch.optim import AdamW, cosine_schedule
    gen = torch.Generator().manual_seed(4)
    params = {"w": torch.randn(64, 32, generator=gen),
              "b": {"z": torch.randn(32, generator=gen)}}
    grads = [{"w": torch.randn(64, 32, generator=gen) * 10 ** i,
              "b": {"z": torch.randn(32, generator=gen)}} for i in range(3)]
    opt = AdamW(lr=cosine_schedule(3e-3, 2, 5), weight_decay=0.01,
                state_dtype=state_dtype)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _copy(params, torch.device(dev))     # updated in place
        s = opt.init(p)
        for g in grads:
            p, s, n = opt.update(_to(g, torch.device(dev)), s, p)
        out[dev] = (p, s, float(n))
    (pc, sc, nc), (pg, sg, ng) = out["cpu"], out["cuda"]
    assert abs(ng - nc) <= 1e-6 * nc
    assert int(sg["step"]) == 3 and sg["step"].dtype == torch.int32
    for a, b in zip(tree.leaves([pg, sg["m"], sg["v"]]),
                    tree.leaves([pc, sc["m"], sc["v"]])):
        assert a.dtype == b.dtype and a.device.type == "cuda"
        _rel_close(a.float(), b.float(), 1e-6, "adamw")


def test_checkpoint_from_the_card_restores_onto_the_card():
    """Card tensors (float32 parameters, bf16 moments, the int32 step)
    saved and restored onto the card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch import tree
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.launch.specs import params_specs
    from repro_torch.models.model import init_params
    from repro_torch.optim import AdamW
    from repro_torch.storage import ObjectStore
    card = torch.device("cuda", 0)
    cfg = get_reduced("hymba-1.5b")
    params = init_params(cfg, torch.Generator(card).manual_seed(0))
    opt = AdamW(state_dtype=torch.bfloat16)
    state = opt.init(params)
    for t in tree.leaves([state["m"], state["v"]]):
        t.normal_()
    state["step"] += 9
    store = ObjectStore(tier="local")
    save_checkpoint(store, "card", 9, {"params": params, "opt": state})
    tmpl = {"params": params_specs(cfg)}
    tmpl["opt"] = opt.init(tmpl["params"])
    back, step = load_checkpoint(store, "card", tmpl, device=card)
    assert step == 9
    for a, b in zip(tree.leaves(back), tree.leaves({"params": params,
                                                    "opt": state})):
        assert a.device == card and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_exchange_hash_on_the_card_equals_the_host(card):
    """``hash64`` / ``make_hash_partitioner`` on the card: int64 products
    wrap mod 2^64 there too, and the destinations equal the host's
    ``np_hash_dest`` bit for bit (the CPU side is in
    ``tests/test_torch_hash.py``)."""
    from repro_torch.exec import operators as tops
    i64 = np.iinfo(np.int64)
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array([0, 1, -1, i64.min, i64.max], np.int64),
                        rng.integers(i64.min, i64.max, 10_000,
                                     dtype=np.int64, endpoint=True)])
    y = rng.integers(i64.min, i64.max, x.shape[0], dtype=np.int64)
    h = tops.hash64(torch.from_numpy(x).to(card)).cpu().numpy()
    assert np.array_equal(h.view(np.uint64), tops.hash64_np(x))
    mask = rng.random(x.shape[0]) < 0.8
    for n_dest in (1, 3, 7, 64, 2**31 - 1):
        got, _ = tops.make_hash_partitioner(["x", "y"], n_dest)(
            {"x": torch.from_numpy(x).to(card),
             "y": torch.from_numpy(y).to(card)},
            torch.from_numpy(mask).to(card))
        dest = got["__dest"].cpu().numpy()
        want = tops.np_hash_dest({"x": x, "y": y}, ["x", "y"], n_dest)
        assert np.array_equal(dest[mask], want[mask]), n_dest
        assert (dest[~mask] == -1).all()


# -- the fragment's upload: pinned staging ------------------------------------

UPLOAD_CAP = 4096


def _upload_columns(n, seed):
    rng = np.random.default_rng(seed)
    return {"f64": rng.standard_normal(n),
            "i64": rng.integers(-2**62, 2**62, n),
            "i32": rng.integers(-2**31, 2**31, n, dtype=np.int32),
            "u32": rng.integers(0, 2**32, n, dtype=np.uint32),
            "b": rng.random(n) < 0.5,
            "two": rng.standard_normal((n, 3)).astype(np.float32),
            "strided": rng.integers(-9, 9, (2 * n, 2))[::2, 1]}


def _bits(t):
    return t.cpu().numpy().tobytes()


@pytest.mark.parametrize("n", [0, 1, UPLOAD_CAP - 1, UPLOAD_CAP])
def test_staged_upload_equals_the_cpu_path(card, n):
    """``from_numpy`` on the card stages every column in pinned memory:
    values, pad zeros, mask, dtypes and shapes equal the CPU path's bit
    for bit, and every byte it copied came from the staging."""
    cols = _upload_columns(n, n)
    assert n < 2 or not cols["strided"].flags.contiguous
    want = from_numpy(cols, UPLOAD_CAP, "cpu")
    got = from_numpy(cols, UPLOAD_CAP, card)
    torch.cuda.synchronize()
    for c in cols:
        g, w = got.columns[c], want.columns[c]
        assert g.device.type == "cuda" and g.is_contiguous()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), c
        assert _bits(g) == _bits(w), c
    assert _bits(got.mask) == _bits(want.mask)
    assert int(got.mask.sum()) == n
    assert want.staged == 0
    assert got.staged == sum(t.numel() * t.element_size()
                             for t in (*got.columns.values(), got.mask))


def test_staged_uploads_survive_concurrent_reuse_of_pinned_blocks(card):
    """Eight fragments, each on its own stream, upload twice in a row
    behind a kernel that holds their stream, overwriting their numpy
    sources as soon as each call returns: the pinned blocks freed after
    the first upload may go to no other upload before their copies have
    landed, so every block equals what was sent."""
    n, threads, rounds = 300_000, 8, 2
    barrier = threading.Barrier(threads)
    results, errors = {}, []

    def sent(t, r):
        base = np.arange(n, dtype=np.int64) * 16 + t * 4 + r
        return {"a": base, "b": (base * 3).astype(np.float64),
                "c": (base & 0xFFFF).astype(np.int32)}

    def fragment(t):
        try:
            with _device_scope(card) as sync:
                src = {c: v.copy() for c, v in sent(t, 0).items()}
                barrier.wait(timeout=60)
                blocks = []
                for r in range(rounds):
                    torch.cuda._sleep(20_000_000)   # hold the stream
                    blocks.append(from_numpy(src, bucket_capacity(n), card))
                    for c, v in sent(t, r + 1).items():
                        src[c][:] = v      # the next round's data
                sync()
                results[t] = [{c: blk.columns[c][:n].cpu().numpy()
                               for c in blk.columns} for blk in blocks]
        except Exception as e:             # reported by the main thread
            errors.append(e)

    workers = [threading.Thread(target=fragment, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
        assert not w.is_alive()
    assert not errors, errors
    for t in range(threads):
        for r in range(rounds):
            for c, v in sent(t, r).items():
                np.testing.assert_array_equal(results[t][r][c], v,
                                              err_msg=f"{t} {r} {c}")


# -- the exchange's partition on the card --------------------------------------

def _partition_block(n, cap, seed, keys):
    """``cap`` rows, the first ``n`` valid but a random tenth of them:
    Q3's lineitem producer's columns (int64 key, two float64, an int32)
    and, for two keys, an int32 second key."""
    rng = np.random.default_rng(seed)
    cols = {"l_orderkey": rng.integers(1, 60_000_000, cap, dtype=np.int64),
            "l_extendedprice": rng.uniform(900, 105_000, cap),
            "l_discount": rng.uniform(0, 0.1, cap),
            "l_shipdate": rng.integers(8000, 10600, cap, dtype=np.int32)}
    if len(keys) > 1:
        cols["k2"] = rng.integers(-2**31, 2**31, cap, dtype=np.int64) \
            .astype(np.int32)
    mask = np.zeros(cap, bool)
    mask[:n] = rng.random(n) >= 0.1
    return cols, mask


def _partitions(cols, mask, keys, n_dest, device):
    from repro_torch.exec import operators as tops
    from repro_torch.kernels import hash_partition as hp
    tc = {c: torch.from_numpy(v).to(device) for c, v in cols.items()}
    tm = torch.from_numpy(mask).to(device)
    part = hp.hash_partition_cuda if tm.is_cuda else hp.hash_partition_plain
    dp = part([tc[k] for k in keys], tc, tm, n_dest)

    def key_hash(a, b):
        return tops.combine_hash([dp.columns[k][a:b] for k in keys]) \
            .cpu().numpy().view(np.uint64)

    counts, kmv = hp.finish(dp, *hp.download(dp), key_hash)
    rows = int(counts.sum())
    meta = dp.meta.cpu().numpy()
    base, cand_n = meta[hp.MAX_DEST:2 * hp.MAX_DEST], \
        meta[2 * hp.MAX_DEST:3 * hp.MAX_DEST]
    cand = dp.cand.cpu().numpy().view(np.uint64)
    return {"cols": {c: t[:rows].cpu().numpy() for c, t in
                     dp.columns.items()},
            "meta": meta,
            "cand": [np.sort(cand[b:b + k]) for b, k in
                     zip(base[:n_dest], cand_n[:n_dest])],
            "counts": counts, "kmv": kmv}


@pytest.mark.parametrize("n,cap,n_dest,keys", [
    (2_000_000, 1 << 21, 9, ["l_orderkey"]),          # Q3's SF 10 producer
    (1 << 20, 1 << 20, 16, ["l_orderkey", "k2"]),
    (5000, 8192, 1, ["l_orderkey"]),
    (0, 1024, 9, ["l_orderkey"]),
    (4097, 8192, 2, ["l_shipdate"])])
def test_hash_partition_kernel_equals_plain(card, n, cap, n_dest, keys):
    """``csrc/hash_partition.cu`` against its plain version bit for bit:
    the rows of each destination in row order, the counts, thresholds
    and candidate sets, the sketches; one counted
    launch; and the host's partition of the same rows."""
    from repro_torch.exec import exchange
    cols, mask = _partition_block(n, cap, n, keys)
    got = _launched("hash_partition",
                    lambda: _partitions(cols, mask, keys, n_dest, card))
    want = _partitions(cols, mask, keys, n_dest, "cpu")
    for c in cols:
        assert _bits_np(got["cols"][c]) == _bits_np(want["cols"][c]), c
    assert np.array_equal(got["meta"], want["meta"])
    for g, w in zip(got["cand"], want["cand"]):
        assert np.array_equal(g, w)
    assert got["kmv"] == want["kmv"]
    host = exchange.partition_rows({c: v[mask] for c, v in cols.items()},
                                   keys, n_dest)
    assert np.array_equal(got["counts"], host.counts)
    assert got["kmv"] == host.kmv
    for c in cols:
        assert np.array_equal(got["cols"][c], host.columns[c]), c


def _bits_np(a):
    return np.ascontiguousarray(a).tobytes()


REPART_Q3 = dict(broadcast_threshold_bytes=0, exchange_partitions=9,
                 exchange_strategy="combining")


def _stage_objects(store, res, qid, sem_hashes) -> list[bytes]:
    """The combined exchange objects one run's pipelines of
    ``sem_hashes`` wrote."""
    return sorted(store.get(k).data for p in res.stats.pipelines
                  if p.exchange_strategy and p.sem_hash in sem_hashes
                  for k in store.list("")
                  if f"/{p.sem_hash}@{qid}-" in k and k.endswith("all.spax"))


def test_repartitioned_q3_join_stage_runs_sort_agg_on_the_card(session):
    """TPC-H Q3 with its joins repartitioned (9 partitions), dispatch on:
    the join stage's aggregate runs the sort_agg kernel over the joins on
    every fragment, one launch a fragment once its program is warm (the
    first run pays the untimed first calls), and the rows are the
    oracle's. Two runs write the partial aggregate's exchange byte for
    byte: the kernel's radix sort and segmented scan add each group's
    rows in one order, where the generic path's ``index_add_`` atomics do
    not."""
    s, catalog, _ = session
    cfg = CoordinatorConfig(use_result_cache=False,
                            planner=PlannerConfig(**REPART_Q3))
    lqp, _ = Binder(catalog).bind(parse(QUERIES["q3"]))
    want = oracle.run(optimize(lqp), _tables(s, catalog))
    objects = []
    with connect(s.store, catalog, config=cfg) as q:
        for _ in range(3):
            before = ext.launches().get("sort_agg", 0)
            h = q.submit(QUERIES["q3"])
            res = h.result(timeout=300)
            launched = ext.launches().get("sort_agg", 0) - before
            got = res.fetch(s.store)
            for c in want:
                np.testing.assert_allclose(
                    np.sort(np.asarray(got[c], float)),
                    np.sort(np.asarray(want[c], float)), **TOL)
            (join,) = [p for p in res.stats.pipelines
                       if p.kernel == "sort_agg"]
            assert join.kernel_fragments == join.n_fragments >= 1
            objects.append(_stage_objects(s.store, res, h.query_id,
                                          {join.sem_hash}))
    assert launched == join.n_fragments
    assert objects[1] and objects[1] == objects[2] == objects[0]


def test_repartitioned_q3_partitions_on_the_card(session):
    """TPC-H Q3 with its joins repartitioned (9 partitions), on the card:
    the oracle's rows, every producer partitioned by the kernel (but one
    whose Bloom filter the host probes itself), and the exchange objects
    the host's partition writes, byte for byte. (The partial aggregate's
    exchange is left out: with dispatch off its sums over exchange rows
    differ in their last bits from run to run; with dispatch on, see
    ``test_repartitioned_q3_join_stage_runs_sort_agg_on_the_card``.)"""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.events import QueryObserver
    s, catalog, _ = session

    class Spans(QueryObserver):
        def __init__(self):
            self.spans = []

        def on_span(self, span):
            self.spans.append(span)

    cfg = CoordinatorConfig(use_result_cache=False, planner=PlannerConfig(
        broadcast_threshold_bytes=0, exchange_partitions=9,
        exchange_strategy="combining"))
    plan = QueryEngine(s.store, catalog, handler=s.handler,
                       config=cfg).plan_sql(QUERIES["q3"])
    compared = {p.sem_hash for p in plan.pipelines.values()
                if p.partitioning.kind == "hash"
                and p.op["t"] != "partial_agg"}
    assert len(compared) >= 4    # lineitem, orders, customer, the join
    before = ext.launches().get("hash_partition", 0)
    objects = {}
    for dispatch in (True, False):
        rec = Spans()
        prev = lower.set_enabled(dispatch)
        try:
            with connect(s.store, catalog, config=cfg,
                         observers=(rec,)) as q:
                h = q.submit(QUERIES["q3"])
                res = h.result(timeout=300)
                got = res.fetch(s.store)
        finally:
            lower.set_enabled(prev)
        lqp, _ = Binder(catalog).bind(parse(QUERIES["q3"]))
        want = oracle.run(optimize(lqp), _tables(s, catalog))
        for c in want:
            np.testing.assert_allclose(np.sort(np.asarray(got[c], float)),
                                       np.sort(np.asarray(want[c], float)),
                                       **TOL)
        wheres = [sp.attrs["where"] for sp in rec.spans
                  if sp.name == "fragment.partition"]
        assert ("kernel" in wheres) == dispatch
        objects[dispatch] = sorted(
            s.store.get(k).data for p in res.stats.pipelines
            if p.exchange_strategy and p.sem_hash in compared
            for k in s.store.list("")
            if f"/{p.sem_hash}@{h.query_id}-" in k
            and k.endswith("all.spax"))
    assert ext.launches().get("hash_partition", 0) > before
    assert objects[True] and objects[True] == objects[False]
