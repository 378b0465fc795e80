"""Fixed-capacity columnar blocks with validity masks.

SQL produces data-dependent cardinalities; the execution layer works on
``Block``s: equal-length column tensors padded to a bucketed capacity
plus a boolean validity mask. Filters flip mask bits; aggregations emit
capacity-bounded outputs; rows are compacted back to numpy only at
fragment output boundaries.

Capacity bucketing (next power of two, floor 1024) is kept from the
reference: it bounds the number of distinct shapes a program meets, and
the fragment driver's untimed first call is keyed by it.

On the card a block is staged in pinned (page-locked) host memory and
copied asynchronously on the current stream: a DMA from pinned memory
runs at the host link's speed, where a copy from pageable memory goes
through CUDA's own bounce buffer at the host's pace.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def bucket_capacity(n: int, floor: int = 1024) -> int:
    cap = floor
    while cap < n:
        cap *= 2
    return cap


def resolve_device(device=None) -> torch.device:
    """The device a session runs its fragments on: the card unless the
    caller asks for the CPU. With no CUDA and no explicit device this
    raises — the port never runs on the CPU without being asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's "
                "plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


# each column's and the mask's offset in a block's host staging
_STAGING_ALIGN = 256


@dataclasses.dataclass
class Block:
    columns: dict[str, torch.Tensor]
    mask: torch.Tensor                # bool[capacity]
    # bytes of the columns and mask copied to the device from pinned
    # host staging (0 where the block was not staged)
    staged: int = 0

    @property
    def capacity(self) -> int:
        return int(self.mask.shape[0])

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]


def from_numpy(columns: dict[str, np.ndarray],
               capacity: int | None = None,
               device: torch.device | str = "cpu") -> Block:
    n = len(next(iter(columns.values()))) if columns else 0
    cap = capacity if capacity is not None else bucket_capacity(n)
    device = torch.device(device)
    for name, arr in columns.items():
        if arr.dtype.kind == "S":
            raise TypeError(
                f"column {name!r} has dtype {arr.dtype}: torch has no "
                "bytes dtype, so fixed-width byte columns cannot enter "
                "a torch block")
    if device.type == "cuda":
        return _staged(columns, n, cap, device)
    cols = {}
    for name, arr in columns.items():
        pad = np.zeros((cap - n,) + arr.shape[1:], dtype=arr.dtype)
        host = torch.from_numpy(np.concatenate([arr, pad]))
        cols[name] = host.to(device, non_blocking=False)
    mask = torch.zeros(cap, dtype=torch.bool)
    mask[:n] = True
    return Block(cols, mask.to(device))


def _staged(columns: dict[str, np.ndarray], n: int, cap: int,
            device: torch.device) -> Block:
    """The card's upload: one pinned host buffer from PyTorch's caching
    host allocator holds every column at its capacity and the mask,
    each at an aligned offset; each is filled in place and copied into
    its own device tensor on the current stream. Freeing the buffer
    right away is safe: the allocator records an event for each
    non-blocking copy from a pinned block and hands the block out again
    only once those copies have completed."""
    layout, total = [], 0
    for name, arr in columns.items():
        shape = (cap,) + arr.shape[1:]
        nbytes = math.prod(shape) * arr.dtype.itemsize
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        layout.append((name, arr, dtype, shape, total, nbytes))
        total = -(-(total + nbytes) // _STAGING_ALIGN) * _STAGING_ALIGN
    staging = torch.empty(total + cap, dtype=torch.uint8, pin_memory=True)
    host = staging.numpy()
    cols = {}
    for name, arr, dtype, shape, off, nbytes in layout:
        view = host[off:off + nbytes].view(arr.dtype).reshape(shape)
        np.copyto(view[:n], arr)
        view[n:] = 0
        cols[name] = staging[off:off + nbytes].view(dtype).view(shape).to(
            device, non_blocking=True)
    mask = host[total:].view(np.bool_)
    mask[:n] = True
    mask[n:] = False
    dev_mask = staging[total:].view(torch.bool).to(device, non_blocking=True)
    staged = sum(nbytes for *_, nbytes in layout) + cap
    return Block(cols, dev_mask, staged)


def to_numpy(block: Block) -> dict[str, np.ndarray]:
    """Compact valid rows back to numpy (host-side, at fragment edges)."""
    mask = block.mask
    return {name: col[mask].cpu().numpy()
            for name, col in block.columns.items()}
