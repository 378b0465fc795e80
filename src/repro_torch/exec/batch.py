"""Fixed-capacity columnar blocks with validity masks.

SQL produces data-dependent cardinalities; the execution layer works on
``Block``s: equal-length column tensors padded to a bucketed capacity
plus a boolean validity mask. Filters flip mask bits; aggregations emit
capacity-bounded outputs; rows are compacted back to numpy only at
fragment output boundaries.

Capacity bucketing (next power of two, floor 1024) is kept from the
reference: it bounds the number of distinct shapes a program meets, and
the fragment driver's untimed first call is keyed by it.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class Block:
    columns: dict[str, torch.Tensor]
    mask: torch.Tensor                # bool[capacity]

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
    cols = {}
    for name, arr in columns.items():
        if arr.dtype.kind == "S":
            raise TypeError(
                f"column {name!r} has dtype {arr.dtype}: torch has no "
                "bytes dtype, so fixed-width byte columns cannot enter "
                "a torch block")
        pad = np.zeros((cap - n,) + arr.shape[1:], dtype=arr.dtype)
        host = torch.from_numpy(np.concatenate([arr, pad]))
        cols[name] = host.to(device, non_blocking=False)
    mask = torch.zeros(cap, dtype=torch.bool)
    mask[:n] = True
    return Block(cols, mask.to(device))


def to_numpy(block: Block) -> dict[str, np.ndarray]:
    """Compact valid rows back to numpy (host-side, at fragment edges)."""
    mask = block.mask
    return {name: col[mask].cpu().numpy()
            for name, col in block.columns.items()}
