"""The four kernels no query reaches (``flash_attention``, ``ssd_scan``
and the fixed-layout ``filter_agg`` / ``groupby_onehot``), their oracles,
and the model modules that size and mirror them (``models.layers``,
``models.ssm``, ``models.config``, ``configs``), each held against the
reference on the CPU.

Every case makes its inputs with numpy from a seed and sends them
through the reference (its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them) and through ``repro_torch`` (the
kernels' plain versions, as ``repro_torch.kernels.ops`` dispatches CPU
tensors). The sweeps repeat ``tests/test_kernels.py`` case for case, at
its tolerances: flash attention 2e-5 (float32) and 2e-2 (bf16), the SSD
scan 5e-5 of the largest output, Q6 rtol 1e-4, grouped sums atol 1e-3
and rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.filter_agg import filter_agg as j_filter_agg
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.groupby_onehot import groupby_onehot as j_groupby
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro.models import config as jmodel_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import config as tmodel_config
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
Q6 = dict(date_lo=8500, date_hi=9500, disc_lo=0.05, disc_hi=0.07,
          qty_hi=24.0)


def _j(a, dtype=None):
    """numpy → jax, in ``dtype`` (a name) where given."""
    a = jnp.asarray(a)
    return a.astype(getattr(jnp, dtype)) if dtype else a


def _t(a, dtype=None):
    """numpy → torch (CPU), in ``dtype`` (a name) where given."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if dtype else t


def _np(x):
    """jax or torch → float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _qkv(seed, heads, kv_heads, S, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((heads, S, hd), np.float32),
            rng.standard_normal((kv_heads, S, hd), np.float32),
            rng.standard_normal((kv_heads, S, hd), np.float32))


# -- flash_attention --------------------------------------------------------

@pytest.mark.parametrize("S,hd,heads,kv_heads", [
    (128, 64, 4, 2), (256, 128, 2, 2), (200, 64, 8, 2), (64, 64, 4, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep(S, hd, heads, kv_heads, dtype, causal):
    q, k, v = _qkv(0, heads, kv_heads, S, hd)
    want = j_flash(_j(q, dtype), _j(k, dtype), _j(v, dtype), causal=causal,
                   interpret=True, block_q=64, block_k=64)
    got = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=causal, block_q=64, block_k=64)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_windowed(window):
    q, k, v = _qkv(1, 2, 2, 192, 64)
    want = j_flash(_j(q), _j(k), _j(v), causal=True, window=window,
                   interpret=True, block_q=64, block_k=64)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48)])
def test_flash_attention_matches_blockwise_attention(causal, window):
    """The kernel's plain version against the port's model layer (heads
    flattened into BH, as the layer's (B, H, S, hd) lays them out)."""
    B, H, Hkv, S, hd = 2, 4, 2, 160, 64
    q, k, v = _qkv(2, B * H, B * Hkv, S, hd)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    want = tlayers.blockwise_attention(
        _t(q).view(B, H, S, hd), _t(k).view(B, Hkv, S, hd),
        _t(v).view(B, Hkv, S, hd), causal=causal, chunk=64, window=window)
    np.testing.assert_allclose(_np(got), _np(want.reshape(B * H, S, hd)),
                               atol=2e-5, rtol=2e-5)


def _attention_with_bf16_p(q, k, v, *, causal, window, split):
    """The bf16 tensor-core kernel's arithmetic in torch: float32 scores
    and softmax of bf16 inputs, P into the PV product as bf16, once
    (``split`` False, as SDPA rounds it) or as hi = bf16(p) plus
    lo = bf16(p - hi), float32 sums, the output rounded to bf16."""
    BH, S, hd = q.shape
    group = BH // k.shape[0]
    kf = k.float().repeat_interleave(group, 0)
    vf = v.float().repeat_interleave(group, 0)
    s = q.float() @ kf.transpose(-1, -2) / np.sqrt(hd)
    i = torch.arange(S)
    keep = torch.ones((S, S), dtype=torch.bool)
    if causal:
        keep &= i[None, :] <= i[:, None]
    if window:
        keep &= i[None, :] > i[:, None] - window
    s = torch.where(keep, s, -1e30)
    p = torch.where(keep, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    hi = p.bfloat16().float()
    o = hi @ vf
    if split:
        o = o + (p - hi).bfloat16().float() @ vf
    return (o / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("S,hd,heads,kv_heads,causal,window", [
    (256, 64, 4, 2, True, 0), (256, 128, 4, 4, False, 0),
    (256, 64, 4, 2, True, 100), (256, 64, 8, 1, True, 0),
])
def test_flash_attention_bf16_needs_p_split(S, hd, heads, kv_heads, causal,
                                            window):
    """Why the bf16 kernel splits P: against the float32 result of the
    plain version on the same bf16 inputs, at chip_smoke.py's half-ulp
    check (rtol 2^-8, atol 2e-5), P split in two bf16 parts leaves no
    output outside, and P rounded once to bf16 leaves more than a tenth
    (the outputs near zero, where the weighted sum cancels)."""
    q, k, v = (_t(a, "bfloat16") for a in _qkv(3, heads, kv_heads, S, hd))
    exact = ops.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal, window=window)

    def outside(split):
        got = _attention_with_bf16_p(q, k, v, causal=causal, window=window,
                                     split=split).float()
        return int(((got - exact).abs() > 2e-5 + 2.0 ** -8 * exact.abs())
                   .sum())
    assert outside(split=True) == 0
    assert outside(split=False) > exact.numel() // 10


# -- ssd_scan -----------------------------------------------------------------

def _ssd_inputs(seed, b, S, H, P, N, A_zero=False, mamba2=False):
    """The reference's test draw (dt near 0.8, A near -1), or with
    ``mamba2`` mamba2-130m's dynamics: dt log-uniform in [1e-3, 0.1] (as
    its dt_bias gives) and A in [-16, -1], a memory of tens to thousands
    of tokens."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), np.float32) * 0.5
    if mamba2:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, S, H)))
        A_log = np.log(rng.uniform(1.0, 16.0, H)).astype(np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, S, H), np.float32)))
        A_log = (np.zeros(H, np.float32) if A_zero
                 else rng.standard_normal(H, np.float32) * 0.3)
    B = rng.standard_normal((b, S, N), np.float32) * 0.5
    C = rng.standard_normal((b, S, N), np.float32) * 0.5
    return x, dt.astype(np.float32), A_log, B, C


@pytest.mark.parametrize("S,H,P,N,chunk", [
    (64, 2, 16, 8, 16), (96, 3, 32, 16, 32), (128, 1, 64, 128, 64),
])
def test_ssd_scan_sweep(S, H, P, N, chunk):
    ins = _ssd_inputs(2, 2, S, H, P, N)
    want = j_ssd(*map(_j, ins), chunk=chunk, interpret=True)
    got = ops.ssd_scan(*map(_t, ins), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ins[0].shape
    err = np.abs(_np(got) - _np(want)).max()
    scale = np.abs(_np(want)).max() + 1e-9
    assert err / scale < 5e-5
    # and against the sequential float64 oracle, as the reference's test
    exact = _np(tref.ssd_scan_ref(*map(_t, ins)))
    assert np.abs(_np(got) - exact).max() / (np.abs(exact).max() + 1e-9) \
        < 5e-5


def test_ssd_scan_ragged_sequence():
    """S not a multiple of the chunk: the dt = 0 padding of the last
    chunk changes nothing."""
    ins = _ssd_inputs(5, 1, 100, 2, 64, 16)
    want = j_ssd(*map(_j, ins), chunk=32, interpret=True)
    got = ops.ssd_scan(*map(_t, ins), chunk=32)
    err = np.abs(_np(got) - _np(want)).max()
    assert err / (np.abs(_np(want)).max() + 1e-9) < 5e-5


def test_ssd_scan_at_mamba2_dynamics():
    """Long memory: the carried state and the tiles before the diagonal
    reach the compared outputs across four chunks."""
    ins = _ssd_inputs(6, 1, 512, 2, 64, 128, mamba2=True)
    want = j_ssd(*map(_j, ins), chunk=128, interpret=True)
    got = ops.ssd_scan(*map(_t, ins), chunk=128)
    err = np.abs(_np(got) - _np(want)).max()
    assert err / (np.abs(_np(want)).max() + 1e-9) < 5e-5
    exact = _np(tref.ssd_scan_ref(*map(_t, ins)))
    assert np.abs(_np(got) - exact).max() / (np.abs(exact).max() + 1e-9) \
        < 5e-5


def test_ssd_matches_model_layer():
    """The kernel's plain version agrees with the port's ssd_chunked."""
    ins = _ssd_inputs(3, 1, 64, 2, 16, 8, A_zero=True)
    a = ops.ssd_scan(*map(_t, ins), chunk=32)
    m = tssm.ssd_chunked(*map(_t, ins), chunk=32)
    np.testing.assert_allclose(_np(a), _np(m), atol=2e-4)


# -- filter_agg (TPC-H Q6) ----------------------------------------------------

def _q6_columns(seed, n):
    rng = np.random.default_rng(seed)
    ship = rng.integers(8000, 10000, n).astype(np.int32)
    disc = (rng.integers(0, 11, n).astype(np.float32)
            / np.float32(100)).astype(np.float32)
    qty = rng.integers(1, 51, n).astype(np.float32)
    price = rng.random(n, np.float32) * np.float32(1e4)
    return ship, disc, qty, price


@pytest.mark.parametrize("n", [100, 4096, 10_000])
@pytest.mark.parametrize("block", [512, 2048])
def test_filter_agg_sweep(n, block):
    cols = _q6_columns(4, n)
    want = j_filter_agg(*map(_j, cols), block=block, interpret=True, **Q6)
    got = ops.filter_agg(*map(_t, cols), block=block, **Q6)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    assert float(got[1]) == float(want[1])
    np.testing.assert_allclose(
        float(got[0]), float(jref.filter_agg_ref(*map(_j, cols), **Q6)),
        rtol=1e-4)


def test_filter_agg_bounds_round_to_float32():
    """Discounts of exactly float32(0.05) and float32(0.07), quantity 24
    and a ship date at date_lo: the reference compares its float32
    columns with the bounds rounded to float32, so 0.07 and 0.05 pass,
    24 fails (< 24) and date_lo passes (>=). As double, 0.07f > 0.07
    would fail."""
    ship = np.array([8500, 8500, 8500, 9499, 9500, 8499], np.int32)
    disc = np.array([0.07, 0.05, 0.07, 0.06, 0.06, 0.06], np.float32)
    qty = np.array([23, 23, 24, 1, 1, 1], np.float32)
    price = np.array([100, 200, 400, 800, 1600, 3200], np.float32)
    cols = (ship, disc, qty, price)
    want = j_filter_agg(*map(_j, cols), block=8, interpret=True, **Q6)
    got = ops.filter_agg(*map(_t, cols), **Q6)
    expect = [np.float32(100) * np.float32(0.07)
              + np.float32(200) * np.float32(0.05)
              + np.float32(800) * np.float32(0.06), 3.0]
    np.testing.assert_allclose(_np(want), expect, rtol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


# -- groupby_onehot -----------------------------------------------------------

@pytest.mark.parametrize("n,K,A", [(100, 6, 2), (5000, 6, 4),
                                   (3000, 120, 1)])
def test_groupby_onehot_sweep(n, K, A):
    rng = np.random.default_rng(5)
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.standard_normal((n, A), np.float32)
    want = j_groupby(_j(gid), _j(vals), n_groups=K, block=512,
                     interpret=True)
    got = ops.groupby_onehot(_t(gid), _t(vals), n_groups=K, block=512)
    assert got.dtype == torch.float32 and got.shape == (K, A)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(
        _np(got), _np(jref.groupby_agg_ref(_j(gid), _j(vals), K)),
        atol=1e-3, rtol=1e-4)


def test_groupby_counts_via_ones_column():
    gid = np.array([0, 1, 0, 2, 0], np.int32)
    vals = np.stack([np.arange(5, dtype=np.float32),
                     np.ones(5, np.float32)], axis=1)
    want = j_groupby(_j(gid), _j(vals), n_groups=3, block=8,
                     interpret=True)
    got = ops.groupby_onehot(_t(gid), _t(vals), n_groups=3, block=8)
    np.testing.assert_allclose(_np(got)[:, 1], [3, 1, 1])
    np.testing.assert_allclose(_np(got), _np(want))


def test_groupby_out_of_range_ids_reach_no_group():
    """gids -1 and K reach no group (their one-hot row is all zero in
    the reference); index_add_ alone would raise on them."""
    gid = np.array([0, -1, 6, 5], np.int32)
    vals = np.ones((4, 1), np.float32)
    want = j_groupby(_j(gid), _j(vals), n_groups=6, block=8,
                     interpret=True)
    got = ops.groupby_onehot(_t(gid), _t(vals), n_groups=6)
    np.testing.assert_array_equal(_np(want)[:, 0], [1, 0, 0, 0, 0, 1])
    np.testing.assert_array_equal(_np(got), _np(want))


# -- the oracles --------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 40)])
def test_flash_attention_ref_matches_reference(causal, window):
    q, k, v = _qkv(6, 4, 2, 96, 64)
    want = jref.flash_attention_ref(_j(q), _j(k), _j(v), causal=causal,
                                    window=window)
    got = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_ssd_scan_ref_matches_reference():
    ins = _ssd_inputs(7, 2, 40, 3, 16, 8)
    want = jref.ssd_scan_ref(*map(_j, ins))
    got = tref.ssd_scan_ref(*map(_t, ins))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


def test_filter_agg_and_groupby_refs_match_reference():
    cols = _q6_columns(8, 3000)
    np.testing.assert_allclose(
        float(tref.filter_agg_ref(*map(_t, cols), **Q6)),
        float(jref.filter_agg_ref(*map(_j, cols), **Q6)), rtol=1e-5)
    rng = np.random.default_rng(8)
    gid = rng.integers(0, 7, 3000).astype(np.int32)
    vals = rng.standard_normal((3000, 3), np.float32)
    np.testing.assert_allclose(
        _np(tref.groupby_agg_ref(_t(gid), _t(vals), 7)),
        _np(jref.groupby_agg_ref(_j(gid), _j(vals), 7)),
        atol=1e-4, rtol=1e-5)


# -- models.layers ------------------------------------------------------------

def _rand(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        shape, np.float32) * np.float32(scale)


def test_rms_norm_matches_reference():
    x, w = _rand(10, 2, 5, 32), _rand(11, 32)
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(_t(x), _t(w), 1e-5)),
        _np(jlayers.rms_norm(_j(x), _j(w), 1e-5)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
def test_apply_rope_matches_reference(fraction):
    x = _rand(12, 2, 3, 7, 16)
    pos = np.arange(3, 10)
    got = tlayers.apply_rope(_t(x), _t(pos), fraction=fraction,
                             theta=10000.0)
    want = jlayers.apply_rope(_j(x), _j(pos), fraction=fraction,
                              theta=10000.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_repeat_kv_matches_reference():
    k = _rand(13, 2, 3, 5, 4)
    np.testing.assert_array_equal(_np(tlayers.repeat_kv(_t(k), 4)),
                                  _np(jlayers.repeat_kv(_j(k), 4)))


@pytest.mark.parametrize("causal,q_offset,chunk,window,T", [
    (True, 0, 16, 0, 48), (False, 0, 32, 0, 48), (True, 8, 20, 0, 56),
    (True, 0, 16, 12, 48),
])
def test_blockwise_attention_matches_reference(causal, q_offset, chunk,
                                               window, T):
    S = T - q_offset
    q, k, v = _rand(14, 2, 4, S, 16), _rand(15, 2, 2, T, 16), \
        _rand(16, 2, 2, T, 16)
    got = tlayers.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                      q_offset=q_offset, chunk=chunk,
                                      window=window)
    want = jlayers.blockwise_attention(_j(q), _j(k), _j(v), causal=causal,
                                       q_offset=q_offset, chunk=chunk,
                                       window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,window", [(64, 16), (40, 16), (12, 16)])
def test_sliding_window_attention_matches_reference(S, window):
    q, k, v = _rand(17, 1, 4, S, 16), _rand(18, 1, 2, S, 16), \
        _rand(19, 1, 2, S, 16)
    got = tlayers.sliding_window_attention(_t(q), _t(k), _t(v),
                                           window=window)
    want = jlayers.sliding_window_attention(_j(q), _j(k), _j(v),
                                            window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_decode_attention_matches_reference_and_needs_no_mesh():
    q, kc, vc = _rand(20, 2, 4, 1, 16), _rand(21, 2, 2, 24, 16), \
        _rand(22, 2, 2, 24, 16)
    got = tlayers.decode_attention(_t(q), _t(kc), _t(vc), 13)
    want = jlayers.decode_attention(_j(q), _j(kc), _j(vc), 13)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    # a mesh must be a DeviceMesh: any other object is refused
    with pytest.raises(TypeError, match="needs a DeviceMesh"):
        tlayers.decode_attention(_t(q), _t(kc), _t(vc), 13, mesh=object())


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(activation):
    tree = {"w1": _rand(23, 16, 24, scale=0.2),
            "w2": _rand(24, 24, 16, scale=0.2),
            "w3": _rand(25, 16, 24, scale=0.2)}
    x = _rand(26, 2, 3, 16)
    got = tlayers.mlp(_t(x), params_from_numpy(tree), activation)
    want = jlayers.mlp(_j(x), jax.tree.map(jnp.asarray, tree), activation)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tlayers.mlp(_t(x), params_from_numpy(tree), "relu6")


def test_params_from_numpy_keeps_keys_layouts_and_bf16_bits():
    tree = {"layers": [{"w": _rand(27, 3, 4)}, {"w": _rand(28, 3, 4)}],
            "emb": np.asarray(jnp.asarray(_rand(29, 5, 2), jnp.bfloat16))}
    got = params_from_numpy(tree)
    assert got["emb"].dtype == torch.bfloat16
    assert got["emb"].view(torch.int16).numpy().tobytes() == \
        tree["emb"].view(np.int16).tobytes()
    assert tree["emb"].dtype == ml_dtypes.bfloat16
    for a, b in zip(got["layers"], tree["layers"]):
        np.testing.assert_array_equal(a["w"].numpy(), b["w"])


# -- models.ssm ---------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (8, 16)])
def test_ssd_chunked_matches_reference(S, chunk):
    ins = _ssd_inputs(30, 2, S, 3, 8, 4)
    got = tssm.ssd_chunked(*map(_t, ins), chunk=chunk)
    want = jssm.ssd_chunked(*map(_j, ins), chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(31)
    state = rng.standard_normal((2, 3, 4, 8), np.float32)
    x = rng.standard_normal((2, 3, 8), np.float32)
    dt = np.abs(rng.standard_normal((2, 3), np.float32))
    A_log = rng.standard_normal(3, np.float32) * 0.3
    B, C = rng.standard_normal((2, 2, 4), np.float32)
    got = tssm.ssd_decode_step(*map(_t, (state, x, dt, A_log, B, C)))
    want = jssm.ssd_decode_step(*map(_j, (state, x, dt, A_log, B, C)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    x, w = _rand(32, 2, 6, 5), _rand(33, 4, 5)
    st = _rand(34, 2, 3, 5) if with_state else None
    got = tssm.causal_conv(_t(x), _t(w), None if st is None else _t(st))
    want = jssm.causal_conv(_j(x), _j(w), None if st is None else _j(st))
    for g, ww in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(ww), atol=1e-6, rtol=1e-6)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for get in ("get_config", "get_reduced"):
        got = getattr(tconfigs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("head_dim_", "padded_vocab", "d_inner", "n_ssm_heads",
                     "attention_free", "sub_quadratic"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v)
            for k, v in tmodel_config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jmodel_config.SHAPES.items()}
