"""The port's join slice against the reference: the generic join probe
and sort-aggregate, the Bloom probe, the join-probe kernel's plain
version, and Q12/Q14/Q19/Q3 plus the selective semi-join end to end.

Inputs are made with numpy from a seed and fed to both packages.
Integers, keys, masks and Bloom verdicts must match exactly; floats
within rtol = atol = 1e-9 (the reference's row parity tolerance); the
kernel's presence counts exactly. Queries run at SF 0.01 on the port's
CPU path (``device="cpu"``: the kernels' plain versions)."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.exec.operators as ref_ops
from repro.exec import lower as ref_lower
from repro.exec.batch import from_numpy as ref_from_numpy
from repro.exec.expr import expr_from_dict as ref_from_dict
from repro.kernels import bloom as ref_bloom
from repro.kernels.join_probe import fused_join_probe_agg as ref_join_kernel
import repro_torch.api as port_api
from repro_torch.core import CoordinatorConfig
from repro_torch.core.engine import QueryEngine, _op_kinds
from repro_torch.exec import lower as port_lower
from repro_torch.exec import operators as port_ops
from repro_torch.exec.batch import bucket_capacity
from repro_torch.exec.batch import from_numpy as port_from_numpy
from repro_torch.exec.expr import expr_from_dict as port_from_dict
from repro_torch.exec.operators import mixed_radix_strides
from repro_torch.kernels import bloom
from repro_torch.kernels import join_probe as jp
from repro_torch.kernels.program import compile_program, eval_slot, \
    for_columns
from repro_torch.sql import oracle
from repro_torch.sql.logical import Binder
from repro_torch.sql.parser import parse
from repro_torch.sql.physical import PlannerConfig
from repro_torch.sql.queries import QUERIES
from repro_torch.sql.rules import optimize
from repro_torch.storage import InputHandler

TOL = dict(rtol=1e-9, atol=1e-9)
SENTINEL = np.iinfo(np.int64).max
SELECTIVE_JOIN = (
    "select l_orderkey, sum(l_extendedprice) as rev "
    "from lineitem, orders "
    "where l_orderkey = o_orderkey and o_totalprice > 500000 "
    "group by l_orderkey")
# the same join grouped by a dictionary-coded column: every later stage
# is a direct-strategy aggregate, so the whole query runs ported arms
SELECTIVE_JOIN_BY_PRIORITY = SELECTIVE_JOIN.replace(
    "l_orderkey, sum", "o_orderpriority, sum").replace(
    "group by l_orderkey", "group by o_orderpriority")
JOIN_KERNEL = {"q12": "join_probe_agg", "q14": "join_probe_agg",
               "q19": "join_probe_agg", "q3": None}


def col(n):
    return {"t": "col", "name": n}


def lit(v):
    return {"t": "lit", "value": v, "kind": "num"}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(cols: dict, n: int, mask: np.ndarray | None = None):
    """The same block in both packages (capacity bucketed; ``mask`` over
    the n valid rows)."""
    cap = bucket_capacity(n)
    rb, pb = ref_from_numpy(cols, cap), port_from_numpy(cols, cap, "cpu")
    rm, pm = rb.mask, pb.mask
    if mask is not None:
        full = np.zeros(cap, bool)
        full[:n] = mask
        rm, pm = rm & jnp.asarray(full), pm & torch.from_numpy(full)
    return (rb.columns, rm), (pb.columns, pm)


# -- generic operators ------------------------------------------------------------

def _join_inputs(seed: int):
    rng = np.random.default_rng(seed)
    nb, npr = int(rng.integers(200, 900)), int(rng.integers(500, 3000))
    bkeys = rng.permutation(3 * nb)[:nb].astype(np.int64)
    build = {"bk": bkeys, "pay": rng.normal(size=nb),
             "code": rng.integers(0, 5, nb).astype(np.int32)}
    pk = rng.integers(-5, 3 * nb + 5, npr).astype(np.int64)
    pk[rng.random(npr) < 0.05] = SENTINEL          # sentinel probe keys
    probe = {"pk": pk, "x": rng.normal(size=npr),
             "code": rng.integers(0, 9, npr).astype(np.int32)}
    return (build, nb, rng.random(nb) < 0.8,       # masked build rows
            probe, npr, rng.random(npr) < 0.9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pk_join_probe_matches(seed):
    build, nb, bmask, probe, npr, pmask = _join_inputs(seed)
    (rb, rbm), (pb, pbm) = _both(build, nb, bmask)
    (rp, rpm), (pp, ppm) = _both(probe, npr, pmask)
    # "code" is on both sides: the probe's column wins, as in the reference
    want, wmask = ref_ops.make_pk_join_probe("pk", "bk", ["pay", "code"])(
        rp, rpm, rb, rbm)
    got, gmask = port_ops.make_pk_join_probe("pk", "bk", ["pay", "code"])(
        pp, ppm, pb, pbm)
    np.testing.assert_array_equal(_np(gmask), _np(wmask))
    assert _np(gmask).sum() > 0
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(_np(got[c]), np.asarray(want[c]))


SORT_AGGS = [["s", "sum", {"t": "bin", "op": "*", "l": col("x"),
                           "r": col("y")}],
             ["c", "count", None],
             ["lo", "min", col("x")],
             ["hi", "max", {"t": "bin", "op": "/", "l": col("i"),
                            "r": lit(3)}]]


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("group_cols", [["g"], ["g", "i"], ["i", "g"]])
def test_sort_agg_matches(group_cols, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 2000))
    cols = {"g": rng.integers(0, 4, n).astype(np.int32),    # tied keys
            "i": rng.integers(-3, 3, n).astype(np.int64),
            "x": rng.normal(size=n), "y": rng.random(n)}
    (rc, rm), (pc, pm) = _both(cols, n, rng.random(n) < 0.7)
    aggs = [(a, f, e) for a, f, e in SORT_AGGS]
    want, wmask = ref_ops.make_sort_agg(
        group_cols, [(a, f, ref_from_dict(e) if e else None)
                     for a, f, e in aggs])(rc, rm)
    got, gmask = port_ops.make_sort_agg(
        group_cols, [(a, f, port_from_dict(e) if e else None)
                     for a, f, e in aggs])(pc, pm)
    gm, wm = _np(gmask), np.asarray(wmask)
    np.testing.assert_array_equal(gm, wm)
    assert 0 < gm.sum() < gm.size                  # empty segments too
    assert sorted(got) == sorted(want)
    for c in group_cols:
        np.testing.assert_array_equal(_np(got[c]), np.asarray(want[c]))
        assert (_np(got[c])[~gm] == SENTINEL).all()
    for a, _, _ in aggs:
        g, w = _np(got[a]), np.asarray(want[a])
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, **TOL)


def test_generic_join_and_sort_on_empty_masks():
    build, nb, _, probe, npr, _ = _join_inputs(5)
    (_, _), (pb, pbm) = _both(build, nb, np.zeros(nb, bool))
    (_, _), (pp, ppm) = _both(probe, npr)
    _, hit = port_ops.make_pk_join_probe("pk", "bk", ["pay"])(
        pp, ppm, pb, pbm)
    assert not hit.any()
    out, mask = port_ops.make_sort_agg(["code"], [("c", "count", None)])(
        pp, torch.zeros_like(ppm))
    assert not mask.any() and (out["code"] == SENTINEL).all()
    assert (out["c"] == 0).all()


# -- Bloom probe ------------------------------------------------------------------

def _bloom_keys(seed: int):
    rng = np.random.default_rng(seed)
    members = rng.integers(0, 1 << 20, 2000).astype(np.int64)
    probes = np.concatenate([
        members[:500],
        rng.integers(-(1 << 40), 1 << 40, 3000),          # negative, ≥ 2^32
        members[:200] + (1 << 32), -members[:200]]).astype(np.int64)
    return members, probes


@pytest.mark.parametrize("bits", [1 << 10, 1 << 14, 1 << 22])
def test_bloom_probe_bit_for_bit(bits):
    members, probes = _bloom_keys(bits)
    words = bloom.bloom_build(members.astype(np.uint32), bits)
    np.testing.assert_array_equal(words, ref_bloom.bloom_build(
        members.astype(np.uint32), bits))
    want = bloom.bloom_probe_np(probes.astype(np.uint32), words, bits)
    ref_jnp = np.asarray(ref_bloom.bloom_probe_jnp(jnp.asarray(probes),
                                                   jnp.asarray(words),
                                                   bits=bits))
    got = bloom.bloom_probe_plain(torch.from_numpy(probes),
                                  bloom.words_tensor(words, "cpu"), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref_jnp)
    assert want[:500].all()                       # no false negatives
    # int32 keys truncate the same way
    k32 = (probes % (1 << 31)).astype(np.int32)
    np.testing.assert_array_equal(
        bloom.bloom_probe_plain(torch.from_numpy(k32),
                                bloom.words_tensor(words, "cpu"),
                                bits).numpy(),
        bloom.bloom_probe_np(k32.astype(np.uint32), words, bits))


@pytest.mark.parametrize("built_by", ["repro", "port"])
def test_filters_cross_between_packages(built_by):
    members, probes = _bloom_keys(7)
    bits = bloom.bloom_bits_for(members.size)
    lib = ref_bloom if built_by == "repro" else bloom
    wire = lib.bloom_to_wire(lib.bloom_build(members.astype(np.uint32),
                                             bits))
    other = bloom if built_by == "repro" else ref_bloom
    f = other.bloom_from_wire(wire)
    want = lib.bloom_probe_np(probes.astype(np.uint32), f["words"], bits)
    if built_by == "repro":
        got = bloom.bloom_probe_plain(
            torch.from_numpy(probes), bloom.words_tensor(f["words"], "cpu"),
            f["bits"], f["k"]).numpy()
    else:
        got = np.asarray(ref_bloom.bloom_probe_jnp(
            jnp.asarray(probes), jnp.asarray(f["words"]), bits=f["bits"],
            k=f["k"]))
    np.testing.assert_array_equal(got, want)


def test_fused_bloom_filter_plain_keeps_the_mask():
    members, probes = _bloom_keys(8)
    words = bloom.words_tensor(bloom.bloom_build(members.astype(np.uint32),
                                                 1 << 12), "cpu")
    mask = torch.from_numpy(np.arange(probes.size) % 3 != 0)
    got = bloom.fused_bloom_filter_plain(torch.from_numpy(probes), mask,
                                         words=words, bits=1 << 12, k=6)
    hit = bloom.bloom_probe_plain(torch.from_numpy(probes), words, 1 << 12)
    assert torch.equal(got, hit & mask)
    with pytest.raises(ValueError, match="words"):
        bloom.bloom_probe_plain(torch.from_numpy(probes), words, 1 << 13)


# -- join-probe kernel, plain version vs the Pallas kernel ---------------------------

JOIN_AGGS = [["s", "sum", {"t": "bin", "op": "*", "l": col("x"),
                           "r": col("pay")}],
             ["c", "count", None],
             ["lo", "min", col("pay")],
             ["hi", "max", {"t": "bin", "op": "-", "l": col("x"),
                            "r": lit(0.5)}]]
JOIN_PRED = {"t": "cmp", "op": "<", "l": col("code"), "r": lit(7)}


@pytest.mark.parametrize("seed", [10, 11])
@pytest.mark.parametrize("grouped", [False, True])
def test_join_probe_plain_matches_pallas(grouped, seed):
    build, nb, bmask, probe, npr, pmask = _join_inputs(seed)
    build["g"] = build.pop("code")                  # payload group column
    (rb, rbm), (pb, pbm) = _both(build, nb, bmask)
    (rp, rpm), (pp, ppm) = _both(probe, npr, pmask)
    group_cols, sizes = (["g"], [5]) if grouped else ([], [])
    K = 5 if grouped else 0
    # the reference's prepass and kernel (interpret mode)
    bk = jnp.where(rbm, rb["bk"], SENTINEL)
    order = jnp.argsort(bk)
    rpay = {c: rb[c][order] for c in ("pay", "g")}
    _, aggs = ref_lower._agg_closures(JOIN_AGGS)
    want = np.asarray(ref_join_kernel(
        rp, rpm, bk[order], rpay, probe_key="pk",
        pred=ref_lower._compile_pred([JOIN_PRED]),
        gid_fn=(ref_lower._gid_fn(group_cols, sizes) if grouped else None),
        aggs=aggs, n_groups=K, block=512, interpret=True))
    # the port's prepass and plain version
    sk, porder = port_ops.sort_build_side(pb, pbm, "bk")
    ppay = {c: pb[c][porder] for c in ("pay", "g")}
    prog = compile_program([JOIN_PRED], [(f, a) for _, f, a in JOIN_AGGS],
                           group_cols=group_cols,
                           strides=mixed_radix_strides(sizes), n_groups=K)
    got = jp.fused_join_probe_agg_plain(pp, ppm, sk, ppay, probe_key="pk",
                                        program=prog).numpy()
    assert got.shape == want.shape
    if grouped:
        np.testing.assert_array_equal(got[:, -1], want[:, -1])
        assert got[:, -1].sum() > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_join_probe_without_hits_keeps_identities():
    build, nb, _, probe, npr, pmask = _join_inputs(12)
    (_, _), (pb, pbm) = _both(build, nb, np.zeros(nb, bool))
    (_, _), (pp, ppm) = _both(probe, npr, pmask)
    sk, order = port_ops.sort_build_side(pb, pbm, "bk")
    assert (sk == SENTINEL).all()
    prog = compile_program([], [(f, a) for _, f, a in JOIN_AGGS])
    got = jp.fused_join_probe_agg_plain(pp, ppm, sk,
                                        {"pay": pb["pay"][order]},
                                        probe_key="pk", program=prog)
    assert got.tolist() == [0.0, 0.0, float("inf"), float("-inf")]


# -- end to end ----------------------------------------------------------------------

class _Recorder:
    """Wraps a worker handler to keep each fragment's stats, and the spec
    of each fragment that carried a semi-join filter."""

    def __init__(self, inner):
        self.stats, self._lock, self._inner = [], threading.Lock(), inner
        self.filtered = []

    def __call__(self, payload):
        resp, runtime = self._inner(payload)
        with self._lock:
            self.stats.append(resp["stats"])
            if payload.get("semijoin"):
                self.filtered.append((payload, resp["stats"]))
        return resp, runtime


def _tables(session, catalog):
    ih = InputHandler(session.store)
    out = {}
    for name in ("lineitem", "orders", "part", "customer"):
        meta = catalog.tables[name]
        parts = [ih.read_table(f)[0] for f in meta.files]
        out[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                     for c in meta.schema}
    return out


@pytest.fixture(scope="module")
def sessions():
    ref = ref_api.connect(tier="local", quota=8)
    port = port_api.connect(tier="local", quota=8, device="cpu")
    ref.ensure_tpch(sf=0.01, n_parts=4)
    catalog = port.ensure_tpch(sf=0.01, n_parts=4)
    rec = _Recorder(port.handler)
    port.handler = rec
    yield ref, port, catalog, rec, _tables(port, catalog)
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


def _oracle(catalog, tables, sql):
    lqp, _ = Binder(catalog).bind(parse(sql))
    return oracle.run(optimize(lqp), tables)


@pytest.mark.parametrize("query", sorted(JOIN_KERNEL))
def test_join_queries_match_repro_and_the_oracle(sessions, query):
    ref, port, catalog, rec, tables = sessions
    sql = QUERIES[query]
    want = ref.sql(sql).fetch(ref.store)
    rec.stats.clear()
    res = port.sql(sql)
    got = res.fetch(port.store)
    _assert_same_rows(got, want, f"{query} vs repro")
    _assert_same_rows(got, _oracle(catalog, tables, sql),
                      f"{query} vs oracle")
    kernel = JOIN_KERNEL[query]
    ran = [s["kernel"] for s in rec.stats if s["kernel"]]
    if kernel is None:
        # Q3 under the default planner at SF 0.01: its final is fused
        # into the merge pipeline, so no stage has a kernel arm, in either
        # package (under the benchmark planner the final runs topk:
        # tests/test_torch_sort.py)
        assert ran == [] and not any(p.kernel for p in res.stats.pipelines)
        return
    (join,) = [p for p in res.stats.pipelines if p.kernel]
    assert join.kernel == kernel
    assert join.kernel_fragments == join.n_fragments >= 1
    assert ran == [kernel] * join.n_fragments


def _engine(port, rec, **planner):
    cfg = CoordinatorConfig(
        planner=PlannerConfig(broadcast_threshold_bytes=1,
                              exchange_partitions=4, **planner),
        use_result_cache=False, pipelined=False, adaptive=False,
        calibrate_selectivity=False)
    return QueryEngine(port.store, port.catalog, platform=port.platform,
                       config=cfg, handler=rec)


@pytest.mark.parametrize("group_by", ["l_orderkey", "o_orderpriority"])
def test_selective_semijoin_runs_the_bloom_probe(sessions, group_by):
    """The selective repartition join with its Bloom filter on (forced:
    SF 0.01 is below the cost gate's break-even): the probe scan runs
    the ``bloom_filter`` arm, kills the rows the host probe would, and
    the rows equal repro's and the oracle's. Grouped by the dictionary-
    coded priority, the join stage runs ``join_probe_agg`` and no stage
    waits for a kernel of a later slice."""
    ref, port, catalog, rec, tables = sessions
    sql = SELECTIVE_JOIN if group_by == "l_orderkey" \
        else SELECTIVE_JOIN_BY_PRIORITY
    eng = _engine(port, rec)
    plan = eng.plan_sql(sql)
    (probe,) = [p for p in plan.pipelines.values() if p.params.semijoin]
    probe.params.semijoin["enabled"] = True
    rec.stats.clear()
    rec.filtered.clear()
    res = eng.execute_plan(plan)
    got = res.fetch(port.store)
    pr = next(r for r in res.stats.pipelines if r.pid == probe.pid)
    assert pr.kernel_fragments == pr.n_fragments
    assert len(rec.filtered) >= pr.n_fragments
    # each probe fragment killed the rows the host probe of its filter
    # kills on the rows it scanned
    ih = InputHandler(port.store)
    for spec, stats in rec.filtered:
        assert stats["kernel"] == "bloom_filter"
        parts, _ = ih.read_tables(spec["scan_units"], ["l_orderkey"], [])
        keys = np.concatenate([t["l_orderkey"] for t in parts])
        f = bloom.bloom_from_wire(spec["semijoin"])
        hit = bloom.bloom_probe_np(keys.astype(np.uint32), f["words"],
                                   f["bits"], f["k"])
        assert stats["semijoin_killed"] == int((~hit).sum()) > 0
    if group_by == "o_orderpriority":
        assert {p.kernel for p in res.stats.pipelines} == \
            {"", "join_probe_agg"}
        assert not any("not yet ported" in p.kernel_miss_reason
                       for p in res.stats.pipelines)
    _assert_same_rows(got, _oracle(catalog, tables, sql),
                      "semijoin vs oracle")
    _assert_same_rows(got, ref.sql(sql).fetch(ref.store),
                      "semijoin vs repro")


@pytest.mark.parametrize("strategy", ["direct", "combining", "multilevel"])
def test_q12_as_a_repartition_join(sessions, strategy):
    """Q12 with both sides shuffled: the join kernel reads two
    ``scan_exchange`` leaves, in barrier mode, under each exchange
    strategy."""
    _, port, catalog, rec, tables = sessions
    eng = _engine(port, rec, exchange_strategy=strategy)
    plan = eng.plan_sql(QUERIES["q12"])
    res = eng.execute_plan(plan)
    (join,) = [p for p in res.stats.pipelines if p.kernel]
    assert join.kernel == "join_probe_agg"
    assert join.kernel_fragments == join.n_fragments >= 1
    ops = _op_kinds(plan.pipelines[join.pid].op)
    assert ops.count("scan_exchange") == 2 and "scan_table" not in ops
    _assert_same_rows(res.fetch(port.store),
                      _oracle(catalog, tables, QUERIES["q12"]),
                      f"q12 {strategy} vs oracle")


# -- the probe predicate before the search -------------------------------------

def _filter_search_residual(prog, pcols, pmask, sk, spay, probe_key):
    """The kernel's order, step by step: the probe predicate on the valid
    rows, then the search and the residual (the plain version, with the
    probe slot dropped) over the rows it passes only."""
    typed = for_columns(prog, pcols, spay)
    live = pmask
    if typed.has_probe_pred:
        live = pmask & (eval_slot(typed, typed.probe_slot, pcols) != 0)
    rows = torch.nonzero(live).flatten()
    sub = {c: v[rows] for c, v in pcols.items()}
    residual = dataclasses.replace(prog, probe_pred=False, _device={},
                                   _variants={})
    return jp.fused_join_probe_agg_plain(
        sub, torch.ones(len(rows), dtype=torch.bool), sk, spay,
        probe_key=probe_key, program=residual), int(live.sum())


def _reference_join(m, rp, rpm, rb, rbm, n_groups):
    """The reference's prepass and kernel (interpret mode) for the port's
    match ``m``: its kernel predicate is the probe and residual
    predicates together, evaluated after the search."""
    bk = jnp.where(rbm, rb[m.build_key].astype(jnp.int64), SENTINEL)
    order = jnp.argsort(bk)
    rpay = {c: rb[c][order] for c in m.payload if c not in rp}
    _, aggs = ref_lower._agg_closures(m.aggs)
    return np.asarray(ref_join_kernel(
        rp, rpm, bk[order], rpay, probe_key=m.probe_key,
        pred=ref_lower._compile_pred(m.probe_preds + m.preds),
        gid_fn=(ref_lower._gid_fn(list(m.group_cols), list(m.sizes))
                if n_groups else None),
        aggs=aggs, n_groups=n_groups, block=512, interpret=True))


def _assert_join_result(got, want, ctx):
    got = got.numpy()
    assert got.shape == want.shape, ctx
    if got.ndim == 2:
        np.testing.assert_array_equal(got[:, -1], want[:, -1], err_msg=ctx)
    np.testing.assert_allclose(got, want, err_msg=ctx, **TOL)


@pytest.mark.parametrize("query,build", [("q12", "orders"), ("q14", "part"),
                                         ("q19", "part")])
def test_join_split_matches_pallas(sessions, query, build):
    """Q12's, Q14's and Q19's join programs as the port lowers them: the
    probe side's filters in the probe-predicate slot, the residual in
    slot 0. Run in the kernel's order (probe predicate, then search and
    residual on the survivors), through the plain version of the split
    program, and as one unsplit program, each equals the reference's
    kernel in interpret mode on SF 0.01 lineitem rows."""
    _, port, catalog, rec, tables = sessions
    eng = QueryEngine(port.store, catalog, platform=port.platform,
                      handler=rec)
    plan = eng.plan_sql(QUERIES[query])
    m = next(port_lower.match_fragment(p.op)
             for p in plan.pipelines.values()
             if p.kernel == "join_probe_agg")
    prog = m.program
    assert prog.has_probe_pred and m.probe_preds
    assert prog.has_pred == bool(m.preds)
    K = prog.n_groups
    n = 16384
    li, bt = tables["lineitem"], tables[build]
    payload = [c for c in m.payload if c in prog.names]
    pnames = sorted({c for c in prog.names if c not in payload}
                    | {m.probe_key})
    bnames = sorted({m.build_key} | set(payload))
    (rp, rpm), (pp, ppm) = _both({c: li[c][:n] for c in pnames}, n)
    nb = len(bt[m.build_key])
    (rb, rbm), (pb, pbm) = _both({c: bt[c] for c in bnames}, nb)
    assert not m.build_preds
    want = _reference_join(m, rp, rpm, rb, rbm, K)
    sk, order = port_ops.sort_build_side(pb, pbm, m.build_key)
    spay = {c: pb[c][order] for c in payload if c not in pp}
    ordered, searched = _filter_search_residual(prog, pp, ppm, sk, spay,
                                                m.probe_key)
    assert 0 < searched < n // 10
    _assert_join_result(ordered, want, f"{query} probe predicate first")
    _assert_join_result(jp.fused_join_probe_agg_plain(
        pp, ppm, sk, spay, probe_key=m.probe_key, program=prog), want,
        f"{query} split program")
    unsplit = compile_program(
        m.probe_preds + m.preds, [(f, a) for _, f, a in m.aggs],
        group_cols=list(m.group_cols),
        strides=mixed_radix_strides(list(m.sizes)), n_groups=K)
    assert not unsplit.has_probe_pred
    _assert_join_result(jp.fused_join_probe_agg_plain(
        pp, ppm, sk, spay, probe_key=m.probe_key, program=unsplit), want,
        f"{query} unsplit program")
    if K:
        assert want[:, -1].sum() > 0


RESIDUAL = {"t": "cmp", "op": ">", "l": col("pay"), "r": lit(-0.5)}
# (probe_preds, preds) of each form of a join program
SPLIT_FORMS = {"probe and residual": ([JOIN_PRED], [RESIDUAL]),
               "probe only": ([JOIN_PRED], []),
               "residual only": ([], [RESIDUAL]),
               "no probe slot": (None, [JOIN_PRED, RESIDUAL]),
               "no predicate": (None, [])}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("form", sorted(SPLIT_FORMS))
def test_join_probe_split_forms_match_pallas(form, grouped):
    """A program with a probe predicate and a residual, with either alone,
    or without a probe slot: the plain version, and the kernel's order
    step by step, equal the reference's kernel given all the predicates
    at once."""
    build, nb, bmask, probe, npr, pmask = _join_inputs(13)
    build["g"] = build.pop("code")
    (rb, rbm), (pb, pbm) = _both(build, nb, bmask)
    (rp, rpm), (pp, ppm) = _both(probe, npr, pmask)
    probe_preds, preds = SPLIT_FORMS[form]
    group_cols, sizes = (["g"], [5]) if grouped else ([], [])
    K = 5 if grouped else 0
    bk = jnp.where(rbm, rb["bk"], SENTINEL)
    order = jnp.argsort(bk)
    _, aggs = ref_lower._agg_closures(JOIN_AGGS)
    want = np.asarray(ref_join_kernel(
        rp, rpm, bk[order], {c: rb[c][order] for c in ("pay", "g")},
        probe_key="pk",
        pred=ref_lower._compile_pred((probe_preds or []) + preds),
        gid_fn=(ref_lower._gid_fn(group_cols, sizes) if grouped else None),
        aggs=aggs, n_groups=K, block=512, interpret=True))
    sk, porder = port_ops.sort_build_side(pb, pbm, "bk")
    ppay = {c: pb[c][porder] for c in ("pay", "g")}
    prog = compile_program(preds, [(f, a) for _, f, a in JOIN_AGGS],
                           group_cols=group_cols,
                           strides=mixed_radix_strides(sizes), n_groups=K,
                           probe_preds=probe_preds)
    assert prog.has_probe_pred == bool(probe_preds)
    _assert_join_result(jp.fused_join_probe_agg_plain(
        pp, ppm, sk, ppay, probe_key="pk", program=prog), want, form)
    ordered, _ = _filter_search_residual(prog, pp, ppm, sk, ppay, "pk")
    _assert_join_result(ordered, want, f"{form}, probe predicate first")


def test_probe_predicate_may_not_read_the_build_side():
    """The probe predicate runs before the search, so a program whose
    probe slot reads a payload column is refused when it is typed."""
    build, nb, bmask, probe, npr, pmask = _join_inputs(14)
    (_, _), (pb, pbm) = _both(build, nb, bmask)
    (_, _), (pp, ppm) = _both(probe, npr, pmask)
    sk, order = port_ops.sort_build_side(pb, pbm, "bk")
    prog = compile_program([], [("count", None)], probe_preds=[RESIDUAL])
    with pytest.raises(ValueError, match="build-side"):
        jp.fused_join_probe_agg_plain(pp, ppm, sk,
                                      {"pay": pb["pay"][order]},
                                      probe_key="pk", program=prog)
