"""Production meshes — the port of ``repro.launch.mesh``.

The reference targets TPU v5e pods: 256 chips a pod laid out (16, 16)
as (data, model), and a multi-pod layout with a leading pure-DP "pod"
axis (2 pods = 512 chips). The functions here return an ``AxisMesh``,
the axis names and sizes that the sharding rule tables
(``parallel/sharding.py``) and the dry run (``launch/dryrun.py``) read.
The same axes over H100s are 16 (data) × 16 (model) GPUs, 32 nodes of 8,
and twice that for two pods. ``device_mesh`` lays an ``AxisMesh`` over
the ranks of a ``torch.distributed`` process group that is already up:
the ``DeviceMesh`` that the model's steps take as ``mesh``. The port has
no launcher (the reference has none either): whoever starts the ranks
(a test, ``chip_smoke.py``) initializes the group, with its address,
world size and rank.

``auto_axis_kwargs`` has no counterpart: it is an argument of
``jax.make_mesh`` (the axes' sharding mode), and an ``AxisMesh`` has no
mode. The reference's ``TPU_V5E`` constants become the card's, which
live with the other H100 figures in ``analysis/roofline.H100_SXM``.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.analysis.roofline import H100_SXM  # noqa: F401 (the card)
from repro_torch.parallel.sharding import AxisMesh


def make_production_mesh(*, multi_pod: bool = False) -> AxisMesh:
    if multi_pod:
        return AxisMesh({"pod": 2, "data": 16, "model": 16})
    return AxisMesh({"data": 16, "model": 16})


def make_debug_mesh(data: int = 2, model: int = 2) -> AxisMesh:
    """Small mesh for CPU tests."""
    return AxisMesh({"data": data, "model": model})


def card_mesh() -> AxisMesh:
    """The one H100 the port runs on."""
    return AxisMesh({"data": 1, "model": 1})


def device_mesh(axis_mesh: AxisMesh, device_type: str = "cuda") -> DeviceMesh:
    """``axis_mesh`` over the ranks of the initialized default process
    group, row-major (the last axis fastest), its axes as the mesh's
    dim names. Raises if no group is up or its world size is not the
    mesh's size."""
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    size = math.prod(axis_mesh.shape.values())
    if dist.get_world_size() != size:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks and the mesh {dict(axis_mesh.shape)} "
                         f"{size}")
    return init_device_mesh(device_type, tuple(axis_mesh.shape.values()),
                            mesh_dim_names=axis_mesh.axis_names)
