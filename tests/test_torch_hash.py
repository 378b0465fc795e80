"""The exchange hash on torch (``repro_torch.exec.operators``:
``hash64``, ``combine_hash``, ``umod``, ``make_hash_partitioner``) bit
for bit against the numpy twin ``hash64_np`` and the reference's
``hash64_jnp``, ``combine_hash_jnp`` and ``make_hash_partitioner``, on
the CPU: 0, ±1, the int64 extremes and 10,000 seeded random values, and
destinations mod 1, 3, 7, 64 and 2^31 − 1, masked rows at −1. The
uint64 products wrap mod 2^64 in int64 here; the card case is in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec import operators as jops  # (its package enables x64)
from repro_torch.exec import operators as tops

I64 = np.iinfo(np.int64)
N_DEST = [1, 3, 7, 64, 2**31 - 1]


def _values(seed=0, n=10_000):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, -1, I64.min, I64.max, I64.min + 1, I64.max - 1],
                     dtype=np.int64)
    return np.concatenate([edges, rng.integers(I64.min, I64.max, n,
                                               dtype=np.int64,
                                               endpoint=True)])


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_int64_products_wrap_mod_2_64():
    x = torch.tensor([I64.max, I64.min, -1, 3], dtype=torch.int64)
    got = _u64(x * tops._M1_I64)
    with np.errstate(over="ignore"):
        want = x.numpy().astype(np.uint64) * np.uint64(tops._M1)
    assert np.array_equal(got, want)


def test_hash64_equals_numpy_and_jax():
    x = _values()
    got = _u64(tops.hash64(torch.from_numpy(x)))
    assert np.array_equal(got, tops.hash64_np(x))
    assert np.array_equal(got, np.asarray(jops.hash64_jnp(jnp.asarray(x))))


def test_hash64_of_int32_keys_sign_extends_as_numpy_does():
    x = _values(1).astype(np.int32)
    got = _u64(tops.hash64(torch.from_numpy(x)))
    assert np.array_equal(got, tops.hash64_np(x))


def test_combine_hash_equals_numpy_and_jax():
    cols = [_values(s) for s in (2, 3, 4)]
    got = _u64(tops.combine_hash([torch.from_numpy(c) for c in cols]))
    assert np.array_equal(got, tops.combine_hash_np(cols))
    assert np.array_equal(got, np.asarray(
        jops.combine_hash_jnp([jnp.asarray(c) for c in cols])))


@pytest.mark.parametrize("n_dest", N_DEST)
def test_unsigned_remainder(n_dest):
    h = tops.hash64_np(_values(5))
    got = tops.umod(torch.from_numpy(h.view(np.int64)), n_dest).numpy()
    assert np.array_equal(got, (h % np.uint64(n_dest)).astype(np.int64))


def test_unsigned_remainder_refuses_what_int64_cannot_hold():
    h = torch.zeros(3, dtype=torch.int64)
    for n in (0, 2**31 + 1):
        with pytest.raises(ValueError):
            tops.umod(h, n)


@pytest.mark.parametrize("n_dest", N_DEST)
def test_partitioner_equals_the_reference(n_dest):
    a, b = _values(6), _values(7)
    rng = np.random.default_rng(n_dest)
    mask = rng.random(a.shape[0]) < 0.8
    jcols = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    want, _ = jops.make_hash_partitioner(["a", "b"], n_dest)(
        jcols, jnp.asarray(mask))
    tcols = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    got, got_mask = tops.make_hash_partitioner(["a", "b"], n_dest)(
        tcols, torch.from_numpy(mask))
    dest = got["__dest"]
    assert dest.dtype == torch.int32
    assert np.array_equal(dest.numpy(), np.asarray(want["__dest"]))
    assert (dest[~torch.from_numpy(mask)] == -1).all()
    # the host path the fragments use routes the valid rows alike
    host = tops.np_hash_dest({"a": a, "b": b}, ["a", "b"], n_dest)
    assert np.array_equal(dest.numpy()[mask], host[mask])
    assert torch.equal(got_mask, torch.from_numpy(mask))
    assert set(got) == {"a", "b", "__dest"}
