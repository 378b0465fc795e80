"""Sorting and segmented scan — the plain torch twins of ``csrc/sortnet.cuh``.

The port of ``repro.kernels.sortnet``. The reference sorts a resident
batch with a select-only bitonic network whose last key is the original
position, so its order is total and stable, and it scans segments with
log-step shifts. The CUDA header keeps that order with a stable LSD
radix sort of encoded key lanes (8-bit digits, constant digits skipped,
started from the identity permutation); these plain versions compute
the same functions for CPU tensors and as the yardstick on the card:

* :func:`lexsort_order` — the permutation the network applies: one
  stable ``torch.sort`` per key, last key first, each ascending or
  descending (``torch.sort(descending=True)``, not negation, which
  overflows at the int64 minimum and flips -0.0). Float keys compare as
  the reference's ``<`` does: -0.0 ties +0.0; NaN, which the reference's
  network cannot order, sorts above +inf, where ``torch.sort`` and the
  CUDA encoding both put it.
* :func:`segmented_scan` — the reference's Hillis–Steele segmented
  inclusive scan, step for step.

Beside them, what the radix sort's launch needs and shows:
:func:`radix_scratch_bytes` (its scratch, as ``sortnet::radix_layout``
carves it), :func:`encode_key` (the ordered bits of ``encode_key``) and
:func:`live_digits` (the passes the sort makes on given lanes).
"""

from __future__ import annotations

import torch

# the radix sort of csrc/sortnet.cuh
RADIX_BINS = 256                 # 8-bit digits
RADIX_DIGITS = 8                 # per 64-bit lane
RADIX_MAX_BLOCK_ROWS = 1 << 12   # kMaxBlockRows
RADIX_MIN_BLOCK_ROWS = 256       # kMinBlockRows
RADIX_TARGET_BLOCKS = 16         # kTargetBlocks
_ALIGN = 256
_STATE_BYTES = 1024
_SIGN = -(1 << 63)               # the u64 sign bit as an int64
_NAN_BITS = -(1 << 51)           # 0xFFF8000000000000: every NaN


def lexsort_order(keys: list, directions: list | None = None):
    """Stable lexicographic order of rows by ``keys`` (first key most
    significant), each ascending (+1, the default) or descending (-1);
    ties keep row order, as ``np.lexsort(keys[::-1])``."""
    dirs = list(directions or []) + [1] * (len(keys) - len(directions or []))
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k, d in zip(reversed(keys), reversed(dirs)):
        k = k[order]
        if k.is_floating_point():
            k = k + 0.0                      # -0.0 becomes +0.0
        order = order[torch.sort(k, descending=d < 0, stable=True).indices]
    return order


def segmented_scan(vals, heads, combine, identity: float):
    """Segmented inclusive scan: ``heads`` marks segment starts; each
    row gets ``combine`` over its segment up to it, so a segment's total
    lands on its last row (log2 n shifted steps, as the reference)."""
    n = int(vals.shape[0])
    flag = heads.to(torch.bool)
    d = 1
    while d < n:
        shifted = torch.cat([torch.full((d,), identity, dtype=vals.dtype,
                                        device=vals.device), vals[:-d]])
        blocked = torch.cat([torch.ones((d,), dtype=torch.bool,
                                        device=flag.device), flag[:-d]])
        vals = torch.where(flag, vals, combine(vals, shifted))
        flag = flag | blocked
        d *= 2
    return vals


def radix_scratch_bytes(n: int, n_lanes: int, block_rows: int) -> int:
    """Bytes of the radix sort's scratch for ``n`` rows of ``n_lanes``
    lanes and a tile of ``block_rows`` rows (``sortnet::radix_layout``):
    its state, the digit totals, the block histograms, the ping-pong
    values and positions and the encoded lanes, each 256-byte aligned."""
    rows = min(block_rows, RADIX_MAX_BLOCK_ROWS)
    while rows > RADIX_MIN_BLOCK_ROWS and n // rows < RADIX_TARGET_BLOCKS:
        rows //= 2                   # sortnet::radix_rows
    nb = -(-n // rows)
    parts = [_STATE_BYTES, 4 * n_lanes * RADIX_DIGITS * RADIX_BINS,
             4 * nb * RADIX_BINS, 8 * n, 8 * n, 4 * n, 4 * n] \
        + [8 * n] * n_lanes
    return sum(-(-p // _ALIGN) * _ALIGN for p in parts)


def encode_key(col, descending: bool = False):
    """The ordered bits of ``sortnet.cuh``'s ``encode_key`` as int64 bit
    patterns: unsigned order of the bits is the order of the keys.
    Integers sign-extend and flip the sign bit; floats map -0.0 to +0.0
    and every NaN above +inf; a descending key is complemented."""
    if col.is_floating_point():
        x = col.double()
        b = x.view(torch.int64)
        u = torch.where(b < 0, ~b, b | _SIGN)
        u = torch.where(x == 0, torch.full_like(b, _SIGN), u)
        u = torch.where(x != x, torch.full_like(b, _NAN_BITS), u)
    else:
        u = col.to(torch.int64) ^ _SIGN
    return ~u if descending else u


def live_digits(lanes: list) -> list:
    """(lane, digit) of every pass the radix sort makes over encoded
    ``lanes`` (lane 0 the invalid flag, 0 or 1): the 8-bit digits that are
    not equal in every row, the last lane's lowest digit first."""
    out = []
    for q in reversed(range(len(lanes))):
        for d in range(1 if q == 0 else RADIX_DIGITS):
            dig = (lanes[q] >> (8 * d)) & 0xFF
            if int(dig.amin()) != int(dig.amax()):
                out.append((q, d))
    return out
