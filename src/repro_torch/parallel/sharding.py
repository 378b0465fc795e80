"""Logical→physical sharding rules for the production meshes — the port
of ``repro.parallel.sharding``'s rule tables.

The reference lays each tensor over a TPU mesh (GSPMD via pjit sharding
annotations):

  * TP  ("model" axis): attention head projections, MLP hidden dim, MoE
    expert axis (expert parallelism), vocab dim of embed/lm_head.
  * FSDP ("data" axis): the non-TP dim of every large parameter is sharded
    over the data axis; parameters are all-gathered at use, gradients
    reduce-scattered.
  * DP  ("pod" + "data"): batch dim of activations; the pod axis is pure
    data parallelism (only gradient all-reduce crosses pods).
  * SP  (long_500k): batch=1, so the sequence dim shards over "data"
    (context parallelism).
  * SSM internals stay TP-free.

Every rule is divisibility-guarded: if a dim doesn't divide the axis size
the axis is dropped for that dim (e.g. whisper's 20 heads on a 16-way
model axis), so every (arch × shape × mesh) cell lowers cleanly.

The port runs on one card and builds no device mesh: a mesh here is its
axis names and sizes (``AxisMesh``, or any object with a ``shape``
mapping and ``axis_names``), and each rule returns the tensor's
``PartitionSpec`` — one entry per dim: an axis name, a tuple of axis
names, or None — where the reference returns a ``NamedSharding`` over
it. The tables are what a multi-card layout of the port would start
from. The model code takes ``mesh`` None only, so ``constrain``,
``head_constraint`` and ``logits_constraint`` are the identity there
and refuse a mesh.
"""

from __future__ import annotations

import dataclasses
import math


class PartitionSpec(tuple):
    """A tensor's layout over the mesh: one entry per dim. A one-axis
    tuple entry is its axis, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """A mesh by its axes alone: ``{"data": 16, "model": 16}``."""
    shape: dict

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    mesh: object
    dp_axes: tuple[str, ...]        # ("data",) or ("pod", "data")
    tp_axis: str = "model"
    fsdp_axis: str = "data"
    shard_sequence: bool = False    # long_500k context parallelism

    @property
    def dp_size(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.dp_axes))

    def axis_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return int(math.prod(self.mesh.shape[a] for a in axis))
        return self.mesh.shape[axis]


def make_plan(mesh, *, shard_sequence: bool = False) -> MeshPlan:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return MeshPlan(mesh, dp, shard_sequence=shard_sequence)


def _spec(plan: MeshPlan, shape, axes, *, strict: bool = True) -> P:
    """Build a PartitionSpec with per-dim guards.

    ``strict`` (argument layouts): the axis must divide the dim.
    Non-strict (layouts inside the step): non-divisible dims are padded
    (e.g. vocab 49155 over 16 shards), so only dim ≥ axis size is
    required. Dims smaller than the axis (8 kv heads on a 16-way model
    axis) always stay replicated."""
    out = []
    for dim, axis in zip(shape, axes):
        if axis is None:
            out.append(None)
            continue
        size = plan.axis_size(axis)
        ok = (dim % size == 0) if strict else (size <= dim)
        out.append(axis if size > 1 and ok else None)
    return P(*out)


def _named(plan: MeshPlan, shape, axes) -> P:
    return _spec(plan, shape, axes)


def _map_named(rule, tree, name: str = ""):
    """``rule(name, leaf)`` over a tree of tensors (or anything with a
    ``shape``), ``name`` the leaf's dict key ("" under a list), keeping
    the tree's structure."""
    if isinstance(tree, dict):
        return {k: _map_named(rule, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(rule, v, "") for v in tree)
    if tree is None:
        return None
    return rule(name, tree)


# -- parameters ---------------------------------------------------------------

def param_shardings(plan: MeshPlan, params_shapes):
    """Spec tree matching a params tree (meta tensors will do)."""
    tp, fs = plan.tp_axis, plan.fsdp_axis

    def col_parallel(shape):
        # Column-parallel weights (qkv, gate/up): shard the columns over
        # both axes, so D stays whole and the batch-parallel dot is kept;
        # fall back to rows over fsdp, columns over tp.
        if shape[-1] % (plan.axis_size(fs) * plan.axis_size(tp)) == 0:
            return _named(plan, shape,
                          (None,) * (len(shape) - 1) + ((fs, tp),))
        return _named(plan, shape, (None,) * (len(shape) - 2) + (fs, tp))

    def rule(name, leaf):
        s = tuple(leaf.shape)
        nd = len(s)
        if name == "embed":
            return _named(plan, s, (tp, fs))
        if name == "lm_head":
            return _named(plan, s, (fs, tp))
        if name in ("wq", "wk", "wv"):
            return col_parallel(s)
        if name == "wo":
            return _named(plan, s, (None, tp, fs))
        if name in ("w1", "w3"):
            if nd == 4:  # MoE (L, E, D, F): expert parallel
                return _named(plan, s, (None, tp, fs, None))
            return col_parallel(s)
        if name == "w2":
            if nd == 4:  # (L, E, F, D)
                return _named(plan, s, (None, tp, None, fs))
            return _named(plan, s, (None, tp, fs))
        if name == "router":
            return _named(plan, s, (None, fs, None))
        if name == "ssm_in":
            return _named(plan, s, (None, fs, None))
        if name == "ssm_out":
            return _named(plan, s, (None, None, fs))
        if name in ("enc_pos", "dec_pos"):
            return _named(plan, s, (None, fs))
        # norms, biases, A_log, conv_w, step counters → replicated
        return P()

    return _map_named(rule, params_shapes)


def opt_state_shardings(plan: MeshPlan, params_shapes, opt_shapes):
    """m/v mirror the parameter shardings; scalars replicate."""
    pshard = param_shardings(plan, params_shapes)
    return {"m": pshard, "v": pshard, "step": P()}


# -- activations / batches ----------------------------------------------------

def batch_shardings(plan: MeshPlan, batch_shapes):
    dp = plan.dp_axes

    def rule(name, leaf):
        s = tuple(leaf.shape)
        if len(s) >= 2 and plan.shard_sequence and s[0] == 1:
            # long-context: batch 1 → shard sequence (context parallelism)
            return _named(plan, s, (None, plan.fsdp_axis)
                          + (None,) * (len(s) - 2))
        if len(s) >= 1:
            return _named(plan, s, (dp,) + (None,) * (len(s) - 1))
        return P()

    return _map_named(rule, batch_shapes)


def cache_shardings(plan: MeshPlan, cache_shapes):
    """KV/SSM cache: batch over DP; cache length over the model axis
    (sequence-sharded KV — works for any kv-head count); SSM state P-dim
    over the model axis."""
    dp, tp = plan.dp_axes, plan.tp_axis

    def rule(name, leaf):
        s = tuple(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            return _named(plan, s, (None, dp, None, tp, None))
        if name == "ssm_state":
            return _named(plan, s, (None, dp, None, None, tp))
        if name == "conv_state":
            return _named(plan, s, (None, dp, None, tp))
        return P()

    return _map_named(rule, cache_shapes)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("the port runs on one card and lays out no "
                         "tensor over a mesh: mesh must be None")


def constrain(mesh, x, axes):
    """The reference's divisibility-guarded layout constraint: the
    identity (``mesh`` must be None)."""
    _no_mesh(mesh)
    return x


def dp_axes_of(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def head_constraint(mesh, x):
    """(B, H, S, hd) attention tensors: the identity (``mesh`` None)."""
    _no_mesh(mesh)
    return x


def logits_constraint(plan: MeshPlan | None, x):
    """Vocab-sharded logits: the identity (``plan`` None)."""
    _no_mesh(plan)
    return x
