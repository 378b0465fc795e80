"""Semi-join Bloom filters — build, merge, probe (host numpy half).

This is the numpy half of ``repro.kernels.bloom``: sizing, build, merge,
host probe, key extraction and the wire format, so filters stay
interchangeable between the two packages. The device probe (the torch
twin and the CUDA kernel) comes with the join slice of the port; until
then ``exec.lower`` reports the ``bloom_filter`` arm as not yet ported
and the fragment driver kills rows on the host.

When a pipeline materializes the build side of a repartition join, each
worker folds the join-key column of its output into a compact Bloom
filter; the coordinator OR-merges the per-fragment words and publishes
the merged filter in the build exchange's manifest. Probe-side scan
fragments then test every row against the filter *before* partitioning,
so rows that cannot find a join partner die on the worker that scanned
them instead of being shuffled (requests + bytes are the dominant
serverless cost — see ``CostModel.semijoin_benefit``).

All three probe paths — host numpy (the l0-write kill in
``exec.fragment``), traced jnp (the fallback fragment program), and the
Pallas kernel (``fused_bloom_filter``, dispatched by ``exec.lower``) —
share one hash family so a bit set by any builder is found by every
prober:

  * double hashing over a 32-bit murmur3 finalizer (``fmix32``):
    ``pos_i = (h1 + i·h2) & (n_bits − 1)`` with ``h2`` forced odd, so
    the k probes cycle the full power-of-two bit space. 32-bit lanes
    keep the same arithmetic exact on the TPU VPU (no 64-bit lanes in
    Mosaic) and in numpy.
  * two key modes, recorded in the filter so build and probe always
    apply the identical transform: ``u32`` truncates a single integer
    join-key column (kernel-eligible); ``hash64`` takes the low 32 bits
    of the engine's combined uint64 key hash (multi-column or
    non-integer keys; host-side only).

Sizing: ``n_bits = pow2(~12 bits per expected distinct key)``, k = 6,
for a theoretical false-positive rate around 0.4% (residue rows are
still shuffled but then dropped by the exact join).
"""

from __future__ import annotations

import math

import numpy as np

BLOOM_K = 6
BLOOM_BITS_PER_KEY = 12
BLOOM_MIN_BITS = 1 << 10            # 128 B floor: never degenerate
BLOOM_MAX_BITS = 1 << 22            # 512 KiB cap: stays VMEM-resident
_SEED1 = np.uint32(0x9E3779B9)
_SEED2 = np.uint32(0x41C64E6D)
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(_M1)
        x ^= x >> np.uint32(13)
        x *= np.uint32(_M2)
        x ^= x >> np.uint32(16)
    return x


def bloom_bits_for(n_keys: int, *, bits_per_key: int = BLOOM_BITS_PER_KEY,
                   max_bits: int = BLOOM_MAX_BITS) -> int:
    """Power-of-two filter size for an expected distinct-key count
    (typically a KMV estimate), clamped to [BLOOM_MIN_BITS, max_bits]."""
    want = max(int(n_keys), 1) * bits_per_key
    bits = 1 << max(math.ceil(math.log2(max(want, 1))), 0)
    return max(BLOOM_MIN_BITS, min(bits, max_bits))


def bloom_fpr(n_keys: int, n_bits: int, k: int = BLOOM_K) -> float:
    """Theoretical false-positive rate (1 - e^{-kn/m})^k."""
    if n_bits <= 0:
        return 1.0
    return (1.0 - math.exp(-k * max(n_keys, 0) / n_bits)) ** k


def bloom_build(keys_u32: np.ndarray, n_bits: int,
                k: int = BLOOM_K) -> np.ndarray:
    """Set the k bit positions of every key; returns the uint32 words
    (n_bits/32 of them). ``n_bits`` must be a power of two."""
    assert n_bits & (n_bits - 1) == 0, n_bits
    words = np.zeros(n_bits // 32, dtype=np.uint32)
    if keys_u32.size == 0:
        return words
    keys_u32 = keys_u32.astype(np.uint32, copy=False)
    with np.errstate(over="ignore"):
        h1 = _fmix32_np(keys_u32 ^ _SEED1)
        h2 = _fmix32_np(keys_u32 ^ _SEED2) | np.uint32(1)
        m = np.uint32(n_bits - 1)
        for i in range(k):
            pos = (h1 + np.uint32(i) * h2) & m
            np.bitwise_or.at(words, pos >> np.uint32(5),
                             np.uint32(1) << (pos & np.uint32(31)))
    return words


def bloom_merge(words_list) -> np.ndarray:
    """OR-union of same-size filters (build fragments are unioned the
    way KMV sketches are merged)."""
    out = None
    for w in words_list:
        w = np.asarray(w, dtype=np.uint32)
        out = w.copy() if out is None else np.bitwise_or(out, w)
    if out is None:
        raise ValueError("bloom_merge of zero filters")
    return out


def bloom_probe_np(keys_u32: np.ndarray, words: np.ndarray, n_bits: int,
                   k: int = BLOOM_K) -> np.ndarray:
    """Membership mask (bool) — no false negatives by construction."""
    if keys_u32.size == 0:
        return np.zeros(0, dtype=bool)
    keys_u32 = keys_u32.astype(np.uint32, copy=False)
    with np.errstate(over="ignore"):
        h1 = _fmix32_np(keys_u32 ^ _SEED1)
        h2 = _fmix32_np(keys_u32 ^ _SEED2) | np.uint32(1)
        m = np.uint32(n_bits - 1)
        hit = np.ones(keys_u32.shape, dtype=bool)
        for i in range(k):
            pos = (h1 + np.uint32(i) * h2) & m
            bit = (words[pos >> np.uint32(5)]
                   >> (pos & np.uint32(31))) & np.uint32(1)
            hit &= bit != 0
    return hit


# -- key extraction (build and probe must agree) --------------------------------

def key_mode_for(columns: dict, key_cols: list[str]) -> str:
    """``u32`` for a single integer key column (kernel-eligible),
    ``hash64`` otherwise."""
    if len(key_cols) == 1:
        col = columns.get(key_cols[0])
        if col is not None and col.dtype.kind in "iu":
            return "u32"
    return "hash64"


def keys_u32(columns: dict, key_cols: list[str], mode: str) -> np.ndarray:
    """The 32-bit key stream a filter is built over / probed with.
    Both sides of a join must use the same mode or false negatives
    appear — the mode travels inside the published filter."""
    if mode == "u32":
        with np.errstate(over="ignore"):
            return columns[key_cols[0]].astype(np.uint32)
    from repro_torch.exec.operators import np_key_hash
    h = np_key_hash(columns, key_cols)
    return (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)


# -- serialization (registry manifests are msgpack) ------------------------------

def bloom_to_wire(words: np.ndarray, *, k: int = BLOOM_K,
                  mode: str = "u32") -> dict:
    words = np.asarray(words, dtype=np.uint32)
    return {"bits": int(words.size * 32), "k": int(k), "mode": mode,
            "words": words.tobytes()}


def bloom_from_wire(d: dict) -> dict:
    """Decoded filter: words as a uint32 array, ready to probe."""
    words = np.frombuffer(d["words"], dtype=np.uint32)
    return {"bits": int(d["bits"]), "k": int(d["k"]),
            "mode": d.get("mode", "u32"), "words": words}
