"""Production meshes — the port of ``repro.launch.mesh``.

The reference targets TPU v5e pods: 256 chips a pod laid out (16, 16)
as (data, model), and a multi-pod layout with a leading pure-DP "pod"
axis (2 pods = 512 chips). The port builds no device mesh (it runs on
one card): a mesh here is its axis names and sizes, an ``AxisMesh``,
which is what the sharding rule tables (``parallel/sharding.py``) and the
dry run (``launch/dryrun.py``) read. The same axes over H100s are 16
(data) × 16 (model) GPUs, 32 nodes of 8, and twice that for two pods.

``auto_axis_kwargs`` has no counterpart: it is an argument of
``jax.make_mesh`` (the axes' sharding mode), and an ``AxisMesh`` has no
mode. The reference's ``TPU_V5E`` constants become the card's, which
live with the other H100 figures in ``analysis/roofline.H100_SXM``.
"""

from __future__ import annotations

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
