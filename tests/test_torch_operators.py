"""The port's generic operators against the reference's jnp ones.

``make_filter``, ``make_project`` and ``make_direct_agg`` on random
capacity-bucketed blocks made with numpy from a seed, fed to both
packages. Masks, integer results and dtypes must match exactly (the
torch promotion traps — ``int * 0.5`` and ``int / int`` give float32 in
torch — included); floats within rtol = atol = 1e-9.
"""

import numpy as np
import pytest
import torch

import repro.exec.operators as ref_ops
from repro.exec.batch import from_numpy as ref_from_numpy
from repro.exec.expr import expr_from_dict as ref_from_dict
from repro_torch.exec import operators as port_ops
from repro_torch.exec.batch import from_numpy as port_from_numpy
from repro_torch.exec.batch import bucket_capacity, resolve_device, to_numpy
from repro_torch.exec.expr import expr_from_dict as port_from_dict

TOL = dict(rtol=1e-9, atol=1e-9)


def col(n):
    return {"t": "col", "name": n}


def lit(v):
    return {"t": "lit", "value": v, "kind": "num"}


def bin_(op, a, b):
    return {"t": "bin", "op": op, "l": a, "r": b}


def cmp(op, a, b):
    return {"t": "cmp", "op": op, "l": a, "r": b}


EXPRS = {
    "int_times_half": bin_("*", col("i"), lit(0.5)),
    "int_div_int": bin_("/", col("i"), col("k")),
    "int32_div_lit": bin_("/", col("d"), lit(7)),
    "int_plus_float_lit": bin_("+", col("i"), lit(2.5)),
    "int32_plus_int_lit": bin_("+", col("d"), lit(3)),
    "int64_minus_int32": bin_("-", col("i"), col("d")),
    "float_mix": bin_("*", col("x"), bin_("-", lit(1), col("y"))),
    "float_div": bin_("/", col("x"), col("y")),
    "case": {"t": "case", "cond": cmp(">", col("x"), lit(0)),
             "then": col("i"), "else": bin_("*", col("y"), lit(2))},
    "cmp_int_float": cmp("<", col("i"), lit(10.5)),
    "in_list": {"t": "in", "term": col("g"), "values": [lit(0), lit(2)]},
    "and_or_not": {"t": "and", "terms": [
        {"t": "or", "terms": [cmp(">=", col("x"), lit(0.1)),
                              cmp("=", col("g"), lit(1))]},
        {"t": "not", "term": cmp("<>", col("h"), lit(0))}]},
}
PREDS = ["cmp_int_float", "in_list", "and_or_not"]


def _columns(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 3000))
    cols = {"i": rng.integers(-20, 40, n).astype(np.int64),
            "k": rng.integers(1, 9, n).astype(np.int64),
            "d": rng.integers(8000, 11000, n).astype(np.int32),
            "x": rng.normal(size=n),
            "y": np.round(rng.random(n) * 0.1, 2),
            "g": rng.integers(0, 3, n).astype(np.int32),
            "h": rng.integers(0, 2, n).astype(np.int32)}
    return cols, bucket_capacity(n)


def _blocks(seed):
    cols, cap = _columns(seed)
    rb = ref_from_numpy(cols, cap)
    pb = port_from_numpy(cols, cap, "cpu")
    return (rb.columns, rb.mask), (pb.columns, pb.mask)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", PREDS)
def test_filter_masks_match(name, seed):
    (rc, rm), (pc, pm) = _blocks(seed)
    _, want = ref_ops.make_filter(ref_from_dict(EXPRS[name]))(rc, rm)
    _, got = port_ops.make_filter(port_from_dict(EXPRS[name]))(pc, pm)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_project_values_and_dtypes_match(name):
    (rc, rm), (pc, pm) = _blocks(2)
    exprs = [("out", EXPRS[name]), ("one", lit(1)), ("copy", col("d"))]
    want, _ = ref_ops.make_project(
        [(n, ref_from_dict(e)) for n, e in exprs])(rc, rm)
    got, gm = port_ops.make_project(
        [(n, port_from_dict(e)) for n, e in exprs])(pc, pm)
    assert gm is pm
    for n in want:
        w, g = np.asarray(want[n]), _np(got[n])
        assert g.dtype == w.dtype, (n, g.dtype, w.dtype)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


AGGS = [["s", "sum", bin_("*", col("x"), col("y"))],
        ["c", "count", None],
        ["lo", "min", bin_("/", col("i"), col("k"))],
        ["hi", "max", col("d")],
        ["m", "sum", col("i")]]


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("groups", [([], []), (["g"], [3]),
                                    (["g", "h"], [3, 2]),
                                    (["h", "g"], [2, 5])])
def test_direct_agg_matches(groups, seed):
    group_cols, sizes = groups
    (rc, rm), (pc, pm) = _blocks(seed)
    rm = rm & (rc["x"] > -0.5)
    pm = pm & (pc["x"] > -0.5)
    rf, rk = ref_ops.make_direct_agg(
        group_cols, sizes, [(n, f, ref_from_dict(a) if a else None)
                            for n, f, a in AGGS])
    pf, pk = port_ops.make_direct_agg(
        group_cols, sizes, [(n, f, port_from_dict(a) if a else None)
                            for n, f, a in AGGS])
    assert rk == pk
    want, wmask = rf(rc, rm)
    got, gmask = pf(pc, pm)
    np.testing.assert_array_equal(_np(gmask), _np(wmask))
    assert sorted(got) == sorted(want)
    for n in want:
        w, g = np.asarray(want[n]), _np(got[n])
        assert g.dtype == w.dtype, (n, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, **TOL)


def test_direct_agg_empty_groups_keep_identities():
    (rc, rm), (pc, pm) = _blocks(5)
    rm = rm & (rc["g"] == 1)
    pm = pm & (pc["g"] == 1)
    rf, _ = ref_ops.make_direct_agg(
        ["g"], [3], [(n, f, ref_from_dict(a) if a else None)
                     for n, f, a in AGGS])
    pf, _ = port_ops.make_direct_agg(
        ["g"], [3], [(n, f, port_from_dict(a) if a else None)
                     for n, f, a in AGGS])
    want, wm = rf(rc, rm)
    got, gm = pf(pc, pm)
    np.testing.assert_array_equal(_np(gm), _np(wm))
    assert _np(gm).tolist() == [False, True, False]
    for n in want:
        np.testing.assert_allclose(_np(got[n]), np.asarray(want[n]), **TOL)


def test_block_round_trip_and_bytes_columns():
    cols, cap = _columns(6)
    blk = port_from_numpy(cols, cap, "cpu")
    assert blk.capacity == cap and int(blk.mask.sum()) == len(cols["i"])
    back = to_numpy(blk)
    for c, v in cols.items():
        np.testing.assert_array_equal(back[c], v)
    with pytest.raises(TypeError, match="bytes"):
        port_from_numpy({"s": np.array([b"ab", b"cd"], "S2")})


def test_resolve_device_refuses_a_silent_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_sort_and_join_wait_for_the_join_slice():
    with pytest.raises(NotImplementedError, match="slice 2"):
        port_ops.make_sort_agg(["g"], [("c", "count", None)])
    with pytest.raises(NotImplementedError, match="slice 2"):
        port_ops.make_pk_join_probe("a", "b", [])


def test_numpy_helpers_are_the_reference_ones():
    cols, _ = _columns(7)
    for keys in (["i"], ["g", "h"], ["d", "i", "k"]):
        np.testing.assert_array_equal(port_ops.np_key_hash(cols, keys),
                                      ref_ops.np_key_hash(cols, keys))
        np.testing.assert_array_equal(port_ops.np_hash_dest(cols, keys, 7),
                                      ref_ops.np_hash_dest(cols, keys, 7))
    h = port_ops.np_key_hash(cols, ["i"])
    assert port_ops.kmv_sketch(h) == ref_ops.kmv_sketch(h)
    assert port_ops.kmv_estimate(port_ops.kmv_sketch(h)) == \
        ref_ops.kmv_estimate(ref_ops.kmv_sketch(h))
    aggs = [("s", "sum"), ("lo", "min")]
    part = {"g": cols["g"], "s": cols["x"], "lo": cols["y"]}
    got = port_ops.np_combine_partials(part, ["g"], aggs)
    want = ref_ops.np_combine_partials(part, ["g"], aggs)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
