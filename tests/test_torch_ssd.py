"""The SSD scan's chunk-parallel design on the CPU: the plain torch model
of the kernel's three phases (``ssd_scan.ssd_scan_phases``: chunk states,
state passing, chunk outputs with C·Bᵀ shared by the heads) against the
reference's ``ssd_scan`` in interpret mode and the sequential float64
oracle, in float32 and with the tensor cores' split-TF32 products; why
the products are split; and the head grouping of the third phase.

Inputs are made with numpy from a seed and fed to both packages. The
tolerance is the reference's: max |err| / max |ref| < 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as j_ssd

from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ssd

TOL = 5e-5


def _inputs(seed, b, S, H, N, mamba2=False, P=64):
    """The reference's test draw (dt near 0.8, A near -1), or with
    ``mamba2`` mamba2-130m's dynamics (dt log-uniform in [1e-3, 0.1], A
    in [-16, -1]), whose long memory reaches the carried state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), np.float32) * 0.5
    if mamba2:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, S, H)))
        A_log = np.log(rng.uniform(1.0, 16.0, H))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, S, H), np.float32)))
        A_log = rng.standard_normal(H, np.float32) * 0.3
    B = rng.standard_normal((b, S, N), np.float32) * 0.5
    C = rng.standard_normal((b, S, N), np.float32) * 0.5
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (x, dt, A_log, B, C)]


def _rel(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return np.abs(g - w).max() / (np.abs(w).max() + 1e-9)


# (b, S, H, N, chunk, draw): S 1000 ragged, one chunk, chunk 1024 with S
# not a multiple of it, N 16 and 128, the mamba2 dt/A draw
CASES = [(1, 1000, 3, 128, 256, "unit"), (1, 1000, 3, 128, 256, "mamba2"),
         (2, 40, 2, 16, 256, "unit"), (1, 1500, 2, 16, 1024, "mamba2"),
         (2, 300, 3, 16, 64, "unit"), (1, 512, 2, 128, 128, "mamba2")]


@pytest.mark.parametrize("products", ["float32", "split"])
@pytest.mark.parametrize("b,S,H,N,chunk,draw", CASES)
def test_ssd_phases_match_reference(b, S, H, N, chunk, draw, products):
    ins = _inputs(S + N, b, S, H, N, mamba2=draw == "mamba2")
    got = ssd.ssd_scan_phases(*map(torch.from_numpy, ins), chunk=chunk,
                              products=products)
    assert got.dtype == torch.float32 and tuple(got.shape) == ins[0].shape
    want = j_ssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    assert _rel(got.numpy(), want) < TOL
    exact = tref.ssd_scan_ref(*map(torch.from_numpy, ins)).numpy()
    assert _rel(got.numpy(), exact) < TOL


@pytest.mark.parametrize("draw", ["unit", "mamba2"])
def test_ssd_scan_tf32_needs_split(draw):
    """Why the kernel splits each product's operands: with TF32 operands
    emulated on the CPU (``ssd_scan.tf32``: the low 13 mantissa bits
    cleared), one TF32 product a term misses 5e-5 of
    max |y| by several times, on the reference's draw and on mamba2's
    dt/A at mamba2's N 128 and chunk 256; the three products of the
    split hi/lo parts hold it with a margin of five (float32 itself is
    about 5e-6 off the float64 oracle at this length)."""
    ins = [torch.from_numpy(a) for a in _inputs(
        11, 1, 768, 4, 128, mamba2=draw == "mamba2")]
    exact = tref.ssd_scan_ref(*ins).numpy()
    one = _rel(ssd.ssd_scan_phases(*ins, chunk=256, products="one"), exact)
    split = _rel(ssd.ssd_scan_phases(*ins, chunk=256, products="split"),
                 exact)
    assert one > 4 * TOL
    assert split < TOL / 5


def test_tf32_clears_the_low_mantissa_bits():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -9),
                      -(1.0 + 2.0 ** -12), float("inf")],
                     dtype=torch.float32)
    assert ssd.tf32(v).tolist() == [1.0, 1.0 + 2.0 ** -10,
                                    -(1.0 + 2.0 ** -9), -1.0, float("inf")]
    bits = ssd.tf32(torch.randn(1000)).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    # the split's parts: hi + tf32(v - hi) is v within 2^-20 |v|
    v = torch.randn(1000) * 100
    hi = ssd.tf32(v)
    assert bool(((hi + ssd.tf32(v - hi) - v).abs()
                 <= 2.0 ** -20 * v.abs()).all())


@pytest.mark.parametrize("bsz,S,H,chunk,want", [
    (8, 4096, 24, 256, 24),     # mamba2-130m: all heads, C·Bᵀ once
    (1, 4096, 50, 256, 10),     # hymba-1.5b's mixer: five groups
    (1, 1000, 24, 256, 2),      # ragged S 1000: twelve groups
    (1, 700, 1, 128, 1),        # one head
])
def test_ssd_head_group(bsz, S, H, chunk, want):
    """Phase 3's heads per CTA on a 132-SM card: all of them where the
    (batch, chunk, strip) units alone make two waves, else as many
    groups as it takes."""
    Q = min(chunk, S)
    nc, strips = -(-S // Q), -(-Q // ssd.STRIP)
    group = ssd.head_group(bsz, nc, strips, H, 132)
    assert group == want and 1 <= group <= H
