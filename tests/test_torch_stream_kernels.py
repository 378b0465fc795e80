"""The two streaming kernels, ``fused_bloom_filter`` (``csrc/bloom.cu``)
and the fixed-layout Q6 ``filter_agg`` (``csrc/filter_agg_q6.cu``), on
the CPU: the host functions that choose each kernel's path
(``bloom.vector_layout``, ``filter_agg.q6_layout``) against a brute-force
enumeration of the rows and loads each path covers, and the plain
versions the kernels are held to on the card against the reference at
ragged lengths.

Inputs are made with numpy from a seed and fed to both packages. Bloom
verdicts must match exactly; Q6's count exactly and its revenue within
rtol 1e-5 (float32 sums over at most 1000 rows, in another order).
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bloom as ref_bloom
from repro.kernels.filter_agg import filter_agg as ref_filter_agg
from repro_torch.kernels import bloom
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import ops

Q6 = dict(date_lo=8500, date_hi=9500, disc_lo=0.05, disc_hi=0.07,
          qty_hi=24.0)


# lengths: every n up to 40 and some around whole chunks of the Bloom
# kernel's vector path (256 rows)
LENGTHS = list(range(41)) + [255, 256, 257, 511, 512, 513, 1000]


@functools.lru_cache(maxsize=None)
def _aligned(bases, widths, sizes, group, g):
    """Whether every vector load of whole group ``g`` is aligned to its
    width: ``bases`` are the columns' addresses, ``sizes`` their element
    bytes, ``widths`` the bytes of each load, which together cover the
    group's rows of each column."""
    return all((b + g * group * s + j * w) % w == 0
               for b, w, s in zip(bases, widths, sizes)
               for j in range(max(1, group * s // w)))


def _enumerate(bases, widths, sizes, group, n):
    """What a kernel that loads ``group`` rows a step as vectors covers,
    found row by row. The vector path is open where every load of a
    group at row 0 would be aligned; it then takes each whole group
    (each of whose loads must be aligned too) and the scalar loop every
    other row. Returns (vector, groups, tail, the rows of each path)."""
    bases, widths, sizes = tuple(bases), tuple(widths), tuple(sizes)
    vector = _aligned(bases, widths, sizes, group, 0)
    vec_rows, groups = [], 0
    if vector:
        for g in itertools.count():
            if (g + 1) * group > n:
                break
            assert _aligned(bases, widths, sizes, group, g)
            vec_rows.extend(range(g * group, (g + 1) * group))
            groups += 1
    taken = set(vec_rows)
    scalar_rows = [r for r in range(n) if r not in taken]
    return vector, groups, len(scalar_rows), vec_rows, scalar_rows


def _offsets(names, swept, off, rest):
    """The swept pointer's offset ``off`` (all of them for "all"), the
    others' from ``rest`` in order."""
    if swept == "all":
        return [off] * len(names)
    it = iter(rest)
    return [off if c == swept else next(it) for c in names]


@pytest.mark.parametrize("swept", ["key", "mask", "verdict", "all"])
@pytest.mark.parametrize("key_bytes", [8, 4])
def test_bloom_vector_layout_matches_enumeration(key_bytes, swept):
    """One pointer's offset (or all three at once) 0-15, the others at 0,
    2 or 8, over ``LENGTHS``: the path, the whole chunks and the tail
    that ``vector_layout`` gives equal the enumeration's (16-byte key
    vectors, mask and verdict units of a vector's rows), and the two
    paths cover each row once."""
    G, unit = bloom.CHUNK_ROWS, 16 // key_bytes
    names = ["key", "mask", "verdict"]
    for off in range(16):
        for rest in itertools.product((0, 2, 8), repeat=2):
            ko, mo, oo = _offsets(names, swept, off, rest)
            bases = (4096 + ko, 8192 + mo, 1024 + oo)
            for n in LENGTHS:
                vector, chunks, tail, vec, sca = _enumerate(
                    bases, (16, unit, unit), (key_bytes, 1, 1), G, n)
                got = bloom.vector_layout(bases[0], key_bytes, bases[1],
                                          bases[2], n)
                assert got == (vector, chunks, tail), (bases, n)
                assert sorted(vec + sca) == list(range(n))
                assert tail < G if vector else chunks == 0


@pytest.mark.parametrize("swept", ["shipdate", "discount", "quantity",
                                   "extendedprice", "all"])
def test_q6_layout_matches_enumeration(swept):
    """One column's offset (or all four at once) 0-15, the others at 0
    or 8, over ``LENGTHS``: the path, the whole groups and the tail that
    ``q6_layout`` gives equal the enumeration's, and the two paths cover
    each row once."""
    G = fa.GROUP_ROWS
    names = ["shipdate", "discount", "quantity", "extendedprice"]
    for off in range(16):
        for rest in itertools.product((0, 8), repeat=3):
            offs = _offsets(names, swept, off, rest)
            bases = [4096 * (i + 1) + o for i, o in enumerate(offs)]
            for n in LENGTHS:
                vector, groups, tail, vec, sca = _enumerate(
                    bases, (16,) * 4, (4,) * 4, G, n)
                assert fa.q6_layout(bases, n) == (vector, groups, tail), \
                    (offs, n)
                assert sorted(vec + sca) == list(range(n))
                assert tail < G if vector else groups == 0


def _bloom_case(seed, n, key_dtype):
    """Keys over every truncation case (members, negative, 2^32 and
    above, random) and a mask, as numpy, and a filter of members."""
    rng = np.random.default_rng(seed)
    members = rng.integers(0, 1 << 20, 500).astype(np.int64)
    pool = np.concatenate([members[:4], -members[4:8],
                           members[8:12] + (1 << 32),
                           rng.integers(-(1 << 40), 1 << 40, 4)])
    keys = np.concatenate([pool, rng.integers(-(1 << 40), 1 << 40,
                                              max(n - pool.size, 0))])
    keys = rng.permutation(keys[:max(n, pool.size)])[:n].astype(key_dtype)
    mask = rng.random(n) < 0.8
    bits = 1 << 12
    words = bloom.bloom_build(members.astype(np.uint32), bits)
    return keys, mask, words, bits


@pytest.mark.parametrize("key_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("n", [1, 3, 5, 1000])
def test_bloom_plain_matches_reference(n, key_dtype):
    """``bloom_probe_plain`` against the reference's host probe, and the
    masked form (what ``ops.fused_bloom_filter`` runs on a CPU tensor)
    against the reference's Pallas kernel in interpret mode: exact."""
    keys, mask, words, bits = _bloom_case(n * 7 + 1, n, key_dtype)
    tk, tw = torch.from_numpy(keys), bloom.words_tensor(words, "cpu")
    want = ref_bloom.bloom_probe_np(keys.astype(np.uint32), words, bits)
    np.testing.assert_array_equal(
        bloom.bloom_probe_plain(tk, tw, bits).numpy(), want)
    ref = np.asarray(ref_bloom.fused_bloom_filter(
        {"k": jnp.asarray(keys)}, jnp.asarray(mask), pred=None, key="k",
        words=words, bits=bits, interpret=True))
    got = ops.fused_bloom_filter(tk, torch.from_numpy(mask), words=tw,
                                 bits=bits, k=bloom.BLOOM_K, tiling=None)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, want & mask)


@pytest.mark.parametrize("n", [1, 3, 5, 1000])
def test_filter_agg_plain_matches_reference(n):
    """``filter_agg_plain`` against the reference's Pallas kernel in
    interpret mode: the count exact, the revenue within rtol 1e-5. The
    first row passes, so every count is at least 1."""
    rng = np.random.default_rng(n)
    ship = rng.integers(8000, 10000, n).astype(np.int32)
    disc = (rng.integers(0, 11, n) / 100).astype(np.float32)
    qty = rng.integers(1, 51, n).astype(np.float32)
    price = rng.random(n, np.float32) * np.float32(1e4)
    ship[0], disc[0], qty[0] = 9000, np.float32(0.06), 10
    cols = (ship, disc, qty, price)
    want = np.asarray(ref_filter_agg(*map(jnp.asarray, cols),
                                     interpret=True, **Q6))
    got = fa.filter_agg_plain(*map(torch.from_numpy, cols), **Q6).numpy()
    assert got[1] == want[1] >= 1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
