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

A mesh is either its axis names and sizes (``AxisMesh``, or any object
with a ``shape`` mapping and ``axis_names``), which the dry run lays the
tables over, or a ``torch.distributed`` ``DeviceMesh`` whose
``mesh_dim_names`` are the same axes, over which the model's steps run.
Each rule returns the tensor's ``PartitionSpec`` — one entry per dim: an
axis name, a tuple of axis names, or None — where the reference returns
a ``NamedSharding``; ``placements`` turns a spec into the DTensor
placements of a ``DeviceMesh``, ``shard_tree`` lays out a tree every
rank holds whole (the reference's ``device_put`` with a
``NamedSharding``), and ``constrain``, ``head_constraint`` and
``logits_constraint`` redistribute a DTensor to a spec's layout where
the reference calls ``with_sharding_constraint``. Without a mesh they
are the identity; an ``AxisMesh`` has no devices and is refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import tree as tree_lib


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


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of an ``AxisMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    if not hasattr(mesh, "axis_names"):
        require_device_mesh(mesh)       # neither kind of mesh: refused
    return tuple(mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    mesh: object
    dp_axes: tuple[str, ...]        # ("data",) or ("pod", "data")
    tp_axis: str = "model"
    fsdp_axis: str = "data"
    shard_sequence: bool = False    # long_500k context parallelism

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp_axes)

    def axis_size(self, axis) -> int:
        if axis is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        if isinstance(axis, tuple):
            return int(math.prod(sizes[a] for a in axis))
        return sizes[axis]


def make_plan(mesh, *, shard_sequence: bool = False) -> MeshPlan:
    """The plan of an ``AxisMesh`` or a ``DeviceMesh``."""
    return MeshPlan(mesh, dp_axes_of(mesh), shard_sequence=shard_sequence)


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


# -- layouts over a DeviceMesh ------------------------------------------------

def require_device_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a ``DeviceMesh``; anything else is refused."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"a layout needs a DeviceMesh, not a {type(mesh).__name__} (an "
            "AxisMesh names axes and has no devices): build one with "
            "launch/mesh.device_mesh")
    return mesh


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(plan: MeshPlan, spec) -> tuple:
    """A ``PartitionSpec`` as the placements of ``plan``'s ``DeviceMesh``,
    one a mesh dim: ``Shard(d)`` on each axis that tensor dim ``d`` names
    (a tuple entry shards ``d`` over its axes major to minor, in mesh-dim
    order, as JAX orders it), ``Replicate()`` on every other. An axis the
    divisibility guard dropped is absent from the spec, so replicated."""
    mesh = require_device_mesh(plan.mesh)
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"mesh order {tuple(names)}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"spec {spec}: axis {names[m]!r} shards "
                                 "two dims")
            out[m] = Shard(d)
    return tuple(out)


def local_range(mesh: DeviceMesh, axis: str, n: int) -> tuple[int, int]:
    """``[lo, hi)``: this device's chunk of a dim of ``n`` sharded over
    mesh axis ``axis``, as DTensor's ``Shard`` cuts it (``torch.chunk``'s
    sizes)."""
    m = list(mesh.mesh_dim_names).index(axis)
    per = -(-n // mesh.size(m))
    lo = min(n, mesh.get_local_rank(m) * per)
    return lo, min(n, lo + per)


def _as_dtensor(mesh: DeviceMesh, x):
    """A DTensor as it is; a plain tensor, which every rank holds whole, as
    a replicated one."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _FromPartial(torch.autograd.Function):
    """A DTensor from each device's partial sums (``Partial`` on some mesh
    dims). Backward: each partial's gradient is the whole gradient, so it
    comes back replicated over those dims — ``DTensor.from_local`` would
    instead split a replicated gradient into partial shares."""

    @staticmethod
    def forward(ctx, local, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return DTensor.from_local(local, mesh, pl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        whole = [Replicate() if p.is_partial() else p for p in ctx.pl]
        return grad.redistribute(ctx.mesh, whole).to_local(), None, None


def from_partial(local, mesh: DeviceMesh, pl) -> DTensor:
    """``local``, this device's partial sum, as a DTensor with placements
    ``pl`` (``Partial`` where the devices of a mesh dim hold summands)."""
    return _FromPartial.apply(local, mesh, tuple(pl))


def local_batch_map(mesh, fn, batched, shared=()):
    """``fn(*batched, *shared)`` on each device's shard of the batch: the
    ``batched`` tensors (batch first; None passes through) laid out batch
    over DP and whole on every other axis, the ``shared`` ones (the
    parameters ``fn`` reads) whole; ``fn`` sees plain tensors, and each
    tensor it returns comes back a DTensor, batch over DP. For a
    computation that is independent across sequences and needs each
    one whole (the SSM mixer's convolution and scan), this replaces
    DTensor's op by op propagation; a shared tensor's gradient sums the
    devices' batch shards. Without a mesh, ``fn`` on the arguments."""
    if mesh is None:
        return fn(*batched, *shared)
    mesh = require_device_mesh(mesh)
    dp = dp_axes_of(mesh)
    names = mesh.mesh_dim_names
    by_batch = [Shard(0) if n in dp else Replicate() for n in names]
    whole = [Replicate()] * mesh.ndim
    summed = [Partial() if n in dp else Replicate() for n in names]
    batch = next(t.shape[0] for t in batched if t is not None)
    args = [None if t is None else
            _as_dtensor(mesh, t).redistribute(mesh, by_batch).to_local()
            for t in batched]
    args += [_as_dtensor(mesh, t).redistribute(mesh, whole).to_local(
        grad_placements=summed) for t in shared]
    out = fn(*args)

    def back(t):
        shape = (batch,) + tuple(t.shape[1:])
        return DTensor.from_local(t, mesh, by_batch, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    if isinstance(out, tuple):
        return tuple(None if t is None else back(t) for t in out)
    return back(out)


def shard_tree(plan: MeshPlan, tree, specs):
    """``tree``, held whole by every rank, distributed over ``plan``'s
    ``DeviceMesh`` by the matching spec tree (``param_shardings``,
    ``opt_state_shardings``, ``batch_shardings``, ``cache_shardings``):
    each rank keeps its own shard and sends nothing. A leaf that is
    already a DTensor is redistributed."""
    mesh = require_device_mesh(plan.mesh)

    def put(x, spec):
        pl = placements(plan, spec)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, pl)
        return distribute_tensor(x, mesh, pl, src_data_rank=None)
    return tree_lib.tree_map(put, tree, specs)


def like(x, ref):
    """``x`` in ``ref``'s layout: a DTensor redistributed to ``ref``'s
    placements (a gradient whose propagation left it otherwise); a plain
    tensor as it is."""
    if isinstance(x, DTensor) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` read back whole on each rank
    (``full_tensor``); other leaves as they are."""
    return tree_lib.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


@contextlib.contextmanager
def plain_as_replicated(mesh):
    """Inside a step over a ``DeviceMesh``, a plain tensor that meets a
    DTensor (a mask or position ``arange``, an accumulator's zeros), which
    every rank computes whole, counts as replicated. Without a mesh,
    nothing changes. Nests; the previous setting comes back on exit."""
    if mesh is None:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def constrain(mesh, x, axes):
    """The reference's divisibility-guarded ``with_sharding_constraint``:
    ``x`` redistributed to ``axes`` (one entry per dim — an axis name, a
    tuple of axis names, or None) over ``mesh``, a ``DeviceMesh``; the
    identity without one."""
    if mesh is None:
        return x
    plan = make_plan(require_device_mesh(mesh))
    return _lay_out(plan, x, _spec(plan, x.shape, axes, strict=False))


def _lay_out(plan: MeshPlan, x, spec):
    x = _as_dtensor(plan.mesh, x)
    want = placements(plan, spec)
    nested = _nested_gather(x.placements, want)
    if nested is not None:
        return _NestedGather.apply(x, want, *nested)
    return x.redistribute(plan.mesh, want)


def _nested_gather(have, want):
    """``(dim, major, minor)`` where ``have`` shards tensor dim ``dim``
    over two mesh dims, ``major`` first (as a tuple entry such as
    ``("data", "model")`` lays a column-parallel weight), and ``want``
    gathers ``major`` and keeps ``minor``, every other mesh dim alike;
    else None."""
    shards = [m for m, p in enumerate(have) if p.is_shard()]
    if len(shards) != 2:
        return None
    major, minor = shards
    dim = have[major].dim
    if have[minor].dim != dim or not want[major] == Replicate() \
            or want[minor] != have[minor]:
        return None
    if any(want[m] != have[m] for m in range(len(have))
           if m not in (major, minor)):
        return None
    return dim, major, minor


def _swap_chunks(local, mesh: DeviceMesh, major: int, minor: int,
                 back: bool = False):
    """The permutation between the two orders of a dim sharded over mesh
    dims ``major`` (size D) and ``minor`` (size M): device (d, m) holds
    chunk d·M + m in major-first order and chunk m·D + d in minor-first
    order. One point-to-point exchange a device (none on the diagonal
    of a square mesh); ``back``: the inverse."""
    D, M = mesh.size(major), mesh.size(minor)
    coord = list(mesh.get_coordinate())
    d, m = coord[major], coord[minor]

    def rank_of(dd, mm):
        c = list(coord)
        c[major], c[minor] = dd, mm
        return int(mesh.mesh[tuple(c)])
    # forward: send my chunk d·M + m to the device that holds it
    # minor-first, receive chunk m·D + d from its major-first holder
    mine, need = d * M + m, m * D + d
    dst = rank_of(mine % D, mine // D)
    src = rank_of(need // M, need % M)
    if back:
        dst, src = src, dst
    if dst == src == rank_of(d, m):
        return local
    local = local.contiguous()
    out = torch.empty_like(local)
    ops = [dist.P2POp(dist.isend, local, dst),
           dist.P2POp(dist.irecv, out, src)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# the functional collectives' names since torch 2.12, and before
_ALL_GATHER = getattr(funcol, "all_gather_single", None) \
    or funcol.all_gather_tensor
_REDUCE_SCATTER = getattr(funcol, "reduce_scatter_single", None) \
    or funcol.reduce_scatter_tensor


class _NestedGather(torch.autograd.Function):
    """A dim sharded major-first over two mesh dims, gathered over the
    major one and kept over the minor: a point-to-point permutation into
    minor-first order, then one all-gather over the major dim of the
    bytes that stay split over the minor — what GSPMD issues for a
    column-parallel weight's gather at use. DTensor's own redistribute
    would all-gather over both dims and slice. Backward: the gradient,
    summed over the major dim where it is partial there, is
    reduce-scattered back and permuted home."""

    @staticmethod
    def forward(ctx, x, want, dim, major, minor):
        mesh = x.device_mesh
        ctx.mesh, ctx.have, ctx.want = mesh, x.placements, tuple(want)
        ctx.dim, ctx.major, ctx.minor = dim, major, minor
        local = _swap_chunks(x.to_local(), mesh, major, minor)
        full = _ALL_GATHER(local, dim, (mesh, major))
        return DTensor.from_local(funcol.wait_tensor(full), mesh, want,
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        mesh, major, dim = ctx.mesh, ctx.major, ctx.dim
        partial = grad.placements[major].is_partial()
        target = list(ctx.want)
        target[major] = grad.placements[major] if partial else Replicate()
        local = grad.redistribute(mesh, target).to_local()
        if partial:
            part = funcol.wait_tensor(_REDUCE_SCATTER(
                local.contiguous(), "sum", dim, (mesh, major)))
        else:
            part = local.chunk(mesh.size(major), dim)[
                mesh.get_local_rank(major)].contiguous()
        home = _swap_chunks(part, mesh, major, ctx.minor, back=True)
        return (DTensor.from_local(home, mesh, ctx.have, run_check=False),
                None, None, None, None)


def dp_axes_of(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def head_constraint(mesh, x):
    """(B, H, S, hd) attention tensors: batch over DP, heads over TP."""
    if mesh is None:
        return x
    return constrain(mesh, x, (dp_axes_of(mesh), "model", None, None))


def logits_constraint(plan: MeshPlan | None, x):
    """Keep logits vocab-sharded, batch over DP (``plan`` None: the
    identity)."""
    if plan is None:
        return x
    require_device_mesh(plan.mesh)
    return _lay_out(plan, x, _spec(plan, x.shape, (plan.dp_axes,)
                                   + (None,) * (x.dim() - 2)
                                   + (plan.tp_axis,)))
