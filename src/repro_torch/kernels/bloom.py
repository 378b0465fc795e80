"""Semi-join Bloom filters — build, merge, probe.

The port of ``repro.kernels.bloom``. The host half (sizing, build, merge,
host probe, key extraction and the wire format) is numpy and byte-
compatible with the reference's, so filters stay interchangeable between
the two packages. The device half probes in torch: the plain version
:func:`bloom_probe_plain` (uint32 arithmetic in masked int64: torch on
the CPU has no ``>>`` or ``+`` on uint32) and the wrapper of the CUDA
kernel ``csrc/bloom.cu`` (:func:`fused_bloom_filter_cuda`), which
``exec.lower``'s ``bloom_filter`` arm launches.

When a pipeline materializes the build side of a repartition join, each
worker folds the join-key column of its output into a compact Bloom
filter; the coordinator OR-merges the per-fragment words and publishes
the merged filter in the build exchange's manifest. Probe-side scan
fragments then test every row against the filter *before* partitioning,
so rows that cannot find a join partner die on the worker that scanned
them instead of being shuffled (requests + bytes are the dominant
serverless cost — see ``CostModel.semijoin_benefit``).

All three probe paths — host numpy (the kill in ``exec.fragment`` for
hash64 keys), plain torch (the generic fragment program), and the CUDA
kernel (``fused_bloom_filter``, dispatched by ``exec.lower``) — share
one hash family so a bit set by any build is found by every probe:

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
import torch

from repro_torch.kernels import ext

BLOOM_K = 6
BLOOM_BITS_PER_KEY = 12
BLOOM_MIN_BITS = 1 << 10            # 128 B floor: never degenerate
BLOOM_MAX_BITS = 1 << 22            # 512 KiB cap (the reference's VMEM)
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


# -- device probe (torch) ----------------------------------------------------------

NAME = "bloom_filter"
_MASK32 = 0xFFFFFFFF
_KEY_TYPES = {torch.int64: 2, torch.int32: 3}   # program.DTYPE_CODES
CHUNK_ROWS = 256        # csrc/bloom.cu kChunk: rows a warp takes a step


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """The filter's uint32 words as an int32 tensor (same bits) on
    ``device``: what the probes below take."""
    w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w.copy()).to(device)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for x in [0, 2^32), in int64 without overflow:
    the multiplier split in 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _check_filter(words: torch.Tensor, bits: int) -> None:
    if words.dtype != torch.int32 or words.dim() != 1 \
            or words.numel() * 32 != bits or bits & (bits - 1):
        raise ValueError(f"filter of {bits} bits needs {bits // 32} int32 "
                         f"words, got {words.dtype} {tuple(words.shape)}")


def bloom_probe_plain(keys: torch.Tensor, words: torch.Tensor, bits: int,
                      k: int = BLOOM_K) -> torch.Tensor:
    """Membership mask (bool) of ``keys`` (any integer tensor, truncated
    mod 2^32 as ``astype(np.uint32)`` does) in the filter ``words``
    (int32 bits, :func:`words_tensor`): bit for bit
    :func:`bloom_probe_np`."""
    _check_filter(words, bits)
    ku = keys.to(torch.int64) & _MASK32
    h1 = _fmix32_t(ku ^ int(_SEED1))
    h2 = _fmix32_t(ku ^ int(_SEED2)) | 1
    w = words.to(torch.int64) & _MASK32
    hit = torch.ones(ku.shape, dtype=torch.bool, device=ku.device)
    for i in range(k):
        pos = (h1 + i * h2) & (bits - 1)
        hit &= ((w[pos >> 5] >> (pos & 31)) & 1) != 0
    return hit


def fused_bloom_filter_plain(keys: torch.Tensor, mask: torch.Tensor, *,
                             words: torch.Tensor, bits: int,
                             k: int = BLOOM_K) -> torch.Tensor:
    return bloom_probe_plain(keys, words, bits, k) & mask


def vector_layout(key_ptr: int, key_bytes: int, mask_ptr: int,
                  out_ptr: int, n: int) -> tuple[bool, int, int]:
    """How ``csrc/bloom.cu`` covers ``n`` rows at these addresses:
    ``(vector, chunks, tail)``. The vector path loads the keys as 16-byte
    vectors (two int64 or four int32 keys, ``key_bytes`` 8 or 4) and the
    mask bytes and verdicts of a vector's rows as one 2- or 4-byte unit,
    so it needs the key 16-byte and the mask and verdicts unit-aligned at
    row 0; it then takes the ``n // CHUNK_ROWS`` whole chunks of
    :data:`CHUNK_ROWS` rows (one a warp a step) and the scalar loop the
    ``tail`` rows past them. Otherwise ``chunks`` is 0 and the scalar
    loop takes every row."""
    unit = 16 // key_bytes
    vector = key_ptr % 16 == 0 and mask_ptr % unit == 0 \
        and out_ptr % unit == 0
    chunks = n // CHUNK_ROWS if vector else 0
    return vector, chunks, n - chunks * CHUNK_ROWS


def fused_bloom_filter_cuda(keys: torch.Tensor, mask: torch.Tensor, *,
                            words: torch.Tensor, bits: int,
                            k: int = BLOOM_K, tiling) -> torch.Tensor:
    """``mask`` ∧ membership of every row's key, by ``csrc/bloom.cu``.
    ``tiling`` is unused (the dispatch layer passes None): the kernel
    takes a chunk of rows a warp (:func:`vector_layout`) and sizes its
    grid from its occupancy."""
    del tiling
    lib = ext.library("bloom")
    ext.check_mask(mask)
    _check_filter(words, bits)
    dev = mask.device
    if keys.shape != mask.shape or keys.device != dev \
            or words.device != dev:
        raise ValueError(f"keys {tuple(keys.shape)} on {keys.device}, "
                         f"words on {words.device}, mask "
                         f"{tuple(mask.shape)} on {dev}")
    if keys.dtype not in _KEY_TYPES:
        if keys.is_floating_point() or keys.dtype == torch.bool:
            raise TypeError(f"Bloom key dtype {keys.dtype}: integers only")
        keys = keys.to(torch.int64)
    keys, words = keys.contiguous(), words.contiguous()
    n = int(mask.shape[0])
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    _, chunks, _ = vector_layout(keys.data_ptr(), keys.element_size(),
                                 mask.data_ptr(), out.data_ptr(), n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.bloom_launch(keys.data_ptr(), _KEY_TYPES[keys.dtype],
                          mask.data_ptr(), n, chunks, words.data_ptr(), bits,
                          k, out.data_ptr(), stream)
    ext.check(lib, rc, NAME)
    ext.count_launch(NAME)
    return out


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
