"""Fused filter + grouped aggregate with min/max — the port of
``repro.kernels.segmented_minmax.fused_groupby_minmax``, plus the shared
helpers of both grouped kernels (:func:`init_group_tile`,
:func:`grouped_tile_update`, :func:`launch_grouped`).

Contract (as the reference's): the result is (K, A+1) float64, the A
aggregate columns plus a trailing presence count of the rows that
survived the filter. Absent groups hold the identities: 0 for sums and
counts, +inf/-inf for min/max. Rows whose group id falls outside
[0, K) reach no group. :func:`fused_groupby_minmax_cuda` launches the
program's own grouped kernel, compiled at first use as
``fused_groupby``'s is (:mod:`repro_torch.kernels.specialise`,
``csrc/scan_spec.cuh``: the (K, A+1) tile in registers where it is
small, else in shared memory); :func:`fused_groupby_minmax_plain`
computes the same in plain torch over the same expression program.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import specialise
from repro_torch.kernels.common import ACC_DTYPE, NEUTRAL
from repro_torch.kernels.program import Program, eval_slot, for_columns

NAME = "groupby_minmax"


def init_group_tile(fns, n_groups: int, device) -> torch.Tensor:
    """(K, A+1) accumulator seeded with each aggregate's identity."""
    ident = [NEUTRAL[fn] for fn in fns] + [0.0]       # + presence count
    return torch.tensor(ident, dtype=ACC_DTYPE,
                        device=device).repeat(n_groups, 1)


def grouped_tile_update(tile, m, gid, columns: dict,
                        program: Program) -> torch.Tensor:
    """Fold the surviving rows ``m`` with float64 group ids ``gid`` into
    the (K, A+1) tile; ids outside [0, K) go to a spill row that is
    dropped, as the one-hot drops them."""
    K = tile.shape[0]
    ok = m & (gid >= 0) & (gid < K)
    idx = torch.where(ok, gid, float(K)).to(torch.int64)
    work = torch.cat([tile, init_group_tile(program.fns, 1, tile.device)])
    okf = ok.to(ACC_DTYPE)
    out = []
    for a, fn in enumerate(program.fns + ("presence",)):
        col = work[:, a].clone()
        if fn in ("count", "presence"):
            col.index_add_(0, idx, okf)
        elif fn == "sum":
            v = eval_slot(program, 2 + a, columns).expand(m.shape)
            col.index_add_(0, idx, torch.where(ok, v, 0.0))
        else:
            v = eval_slot(program, 2 + a, columns).expand(m.shape)
            col.scatter_reduce_(0, idx, v, "amin" if fn == "min" else "amax",
                                include_self=True)
        out.append(col[:K])
    return torch.stack(out, dim=1)


def grouped_plain(columns: dict, mask, program: Program) -> torch.Tensor:
    """Plain torch version of both grouped kernels."""
    program = for_columns(program, columns)
    m = mask
    if program.has_pred:
        m = m & (eval_slot(program, 0, columns) != 0)
    gid = eval_slot(program, 1, columns).expand(mask.shape)
    tile = init_group_tile(program.fns, program.n_groups, mask.device)
    return grouped_tile_update(tile, m, gid, columns, program)


def launch_grouped(name: str, columns: dict, mask, program: Program,
                   tiling) -> torch.Tensor:
    """Launch the program's compiled grouped kernel (:mod:`.specialise`:
    the tile in registers or in shared memory, by its size) and count
    the launch under the wrapper's ``name`` (``groupby`` or
    ``groupby_minmax``). ``tiling`` is unused (the dispatch layer
    passes None): the grid follows the compiled kernel's occupancy."""
    del tiling
    return specialise.launch(name, columns, mask, program)


def fused_groupby_minmax_plain(columns: dict, mask, *,
                               program: Program) -> torch.Tensor:
    return grouped_plain(columns, mask, program)


def fused_groupby_minmax_cuda(columns: dict, mask, *, program: Program,
                              tiling) -> torch.Tensor:
    return launch_grouped(NAME, columns, mask, program, tiling)
