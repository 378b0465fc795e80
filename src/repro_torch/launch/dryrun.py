"""Dry run: trace every (arch × shape × mesh) cell at full width, with no
device — the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell with XLA for 512 host
placeholder devices, proving that every step is shape-coherent, that
its layout partitions over the production meshes — 16×16 (data, model)
and 2×16×16 (pod, data, model) — and fits each device, and it reads the
roofline terms off the compiled artifact. The port has no XLA and no
partitioner; its counterpart of each piece:

* the compile proof is a trace: one ``cell.step_fn(*cell.arg_specs)``
  on the ``meta`` device (``launch/specs.py``), at full depth, under
  ``FlopCounterMode`` (the step's FLOPs) and a dispatch mode that counts
  the bytes of the storages the step itself keeps alive (its peak). A
  cell's trace does not depend on the mesh, so each (arch, shape) is
  traced once a run;
* per-device argument and output bytes come from the sharding rule
  tables (``parallel/sharding.py``): each leaf holds
  ∏⌈dim / size of its spec's axes⌉ × itemsize, laid out as the
  reference's ``in_shardings`` / ``out_shardings`` lay it; an output the
  reference leaves to XLA (``None``) counts as replicated;
* ``temp_bytes`` (the step's traced peak) and ``fits_card`` are given on
  the ``card`` mesh, the one H100, only: on the production meshes the
  port has no partitioner to say what a device holds while it runs;
* the collective schedule is counted from the rule tables
  (:func:`collective_schedule`) where the reference parses its HLO;
* the analytic residency and traffic come from
  ``analysis/memtraffic.py``, as in the reference.

The trace touches no device: nothing is allocated on the card and
nothing is launched there (the reference's dry run never touches its
chip either). XLA-only pieces keep no counterpart: the HLO text, the
compile, and the L=2 / L=4 depth extrapolation of XLA's cost analysis
(the port's layers and microbatches are Python loops, so the trace
counts each iteration).

``--queries`` is the SQL counterpart: plan every TPC-H query through a
``repro_torch.api`` session (planning only, zero workers invoked).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both|card]
  python -m repro_torch.launch.dryrun --all --out bench/dryrun.jsonl
  python -m repro_torch.launch.dryrun --queries [--sf 0.01]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.analysis import memtraffic
from repro_torch.analysis import roofline as roofline_lib
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import H100_SXM, card_mesh, make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.config import SHAPES
from repro_torch.models.moe import moe_capacity
from repro_torch.parallel import sharding as sh

MESHES = {
    "card": card_mesh,
    "16x16": make_production_mesh,
    "2x16x16": lambda: make_production_mesh(multi_pod=True),
}
# every step computes in bf16 (``models/steps.py``'s compute dtype)
PEAK_FLOPS = H100_SXM["peak_bf16_flops"]
ACT_BYTES = 2                       # a bf16 activation element
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


# -- the trace ---------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages that the ops under it create and
    that are still alive, and their peak. Storages of ``external``
    tensors (the step's arguments, and views or in-place results of
    them) are not counted; ``read`` collects the names of the external
    tensors any op took as an input."""

    def __init__(self, external: dict[str, torch.Tensor]):
        super().__init__()
        self._external = {t.untyped_storage()._cdata: name
                          for name, t in external.items()}
        self._live: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self.read: set[str] = set()
        self.total = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.total -= self._live.pop(key)
        del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                name = self._external.get(t.untyped_storage()._cdata)
                if name is not None:
                    self.read.add(name)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._external:
                continue
            self._live[key] = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, k=key: self._free(k))
            self.total += self._live[key]
            self.peak = max(self.peak, self.total)
        return out


@dataclasses.dataclass
class Trace:
    """One traced step of a cell on ``meta``."""
    flops: int                  # FlopCounterMode's total, the whole step
    step_peak_bytes: int        # the step's own live storages at peak
    outputs: object             # the step's outputs, meta tensors
    read: frozenset             # argument leaves the step read
    seconds: float


def trace_cell(cell) -> Trace:
    """Run ``cell.step_fn`` once on its ``meta`` arguments."""
    named = dict(tree.flatten_with_names(cell.arg_specs))
    t0 = time.perf_counter()
    live = LiveBytes(named)
    with FlopCounterMode(display=False) as flops, live:
        outputs = cell.step_fn(*cell.arg_specs)
    return Trace(int(flops.get_total_flops()), int(live.peak), outputs,
                 frozenset(live.read), time.perf_counter() - t0)


# -- per-device layouts ------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, plan, drop: tuple = ()) -> tuple:
    """A leaf's per-device shape under ``spec``: ⌈dim / size of its
    axes⌉, padded as GSPMD pads; ``drop`` lists axes taken as gathered."""
    out = list(shape)
    for i, entry in enumerate(spec):
        axes = tuple(a for a in _axes(entry) if a not in drop)
        out[i] = -(-out[i] // plan.axis_size(axes)) if axes else out[i]
    return tuple(out)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def layout_bytes(tensors, specs, plan) -> int:
    """Per-device bytes of a tree of tensors under a matching spec tree."""
    return sum(tree.leaves(tree.tree_map(
        lambda t, s: _nbytes(shard_shape(t.shape, s, plan), t.dtype),
        tensors, specs)))


def _replicated(tensors):
    return tree.tree_map(lambda t: sh.P(), tensors)


def argument_layouts(cell, plan) -> tuple:
    """The spec trees of a cell's arguments, as the reference's
    ``_compile_one`` passes them to ``jax.jit`` as ``in_shardings``."""
    params = cell.arg_specs[0]
    p_sh = sh.param_shardings(plan, params)
    if cell.kind == "train":
        return (p_sh, sh.opt_state_shardings(plan, params,
                                             cell.arg_specs[1]),
                sh.batch_shardings(plan, cell.arg_specs[2]))
    if cell.kind == "prefill":
        return p_sh, sh.batch_shardings(plan, cell.arg_specs[1])
    return (p_sh, sh.cache_shardings(plan, cell.arg_specs[1]),
            sh.batch_shardings(plan, cell.arg_specs[2]))


def output_layouts(cell, plan, args_sh, outputs) -> tuple:
    """The spec trees of a cell's outputs (``out_shardings``); where the
    reference passes None, replicated."""
    if cell.kind == "train":
        return args_sh[0], args_sh[1], _replicated(outputs[2])
    if cell.kind == "prefill":
        return (_replicated(outputs[0]),
                sh.cache_shardings(plan, outputs[1]))
    return _replicated(outputs[0]), _replicated(outputs[1]), args_sh[1]


# -- the collective schedule -------------------------------------------------

def _is_layer_leaf(name: str) -> bool:
    """Leaves under a sub-dict (``blocks/``, ``enc_blocks/``, ``cross/``)
    are stacked over layers along dim 0."""
    return "/" in name


def _local_batch(cell, args_sh, plan) -> tuple[int, int]:
    """(sequences, tokens) a device holds: its shard of the token ids."""
    if cell.kind == "decode":
        t, s = cell.arg_specs[2], args_sh[2]
    else:
        t, s = cell.arg_specs[-1]["tokens"], args_sh[-1]["tokens"]
    local = shard_shape(t.shape, s, plan)
    return local[0], math.prod(local)


def collective_schedule(cfg, cell, plan, read, *, remat: bool = True):
    """The collectives one step needs on ``plan``'s mesh, counted from the
    rule tables (``parallel/sharding.py:1-20``), and their bytes: the
    per-device output of each, as the reference's HLO parse counts them.

    * each FSDP-sharded parameter the step reads (its spec names the
      data axis) is all-gathered at use, once a step and, for a leaf
      stacked over layers, once a layer; under remat a layer's leaves are
      gathered again in the recompute;
    * a train step reduce-scatters each such gradient over the data axis,
      and all-reduces it over the pod axis; a gradient the data axis does
      not shard is all-reduced over the DP axes;
    * the tensor-parallel activations (tokens × d_model, bf16) are
      all-reduced after each attention output projection (``wo``) and
      dense MLP down projection (``w2``) whose contracting dim the model
      axis shards: forward, again in the recompute under remat, and
      backward; under sequence parallelism each is a reduce-scatter and
      an all-gather;
    * an MoE layer whose expert axis the model axis shards does an
      all-to-all of its (experts, capacity, d_model) buffer on dispatch
      and on combine, forward, recompute and backward likewise.

    Returns ``(counts by kind, [(kind, axes, bytes), ...])``; on a mesh
    whose axes are all 1 both are empty."""
    mesh = plan.mesh
    train = cell.kind == "train"
    params = cell.arg_specs[0]
    args_sh = argument_layouts(cell, plan)
    seqs, tokens = _local_batch(cell, args_sh, plan)
    fs, tp = plan.fsdp_axis, plan.tp_axis
    dp = tuple(a for a in plan.dp_axes if mesh.shape[a] > 1)
    pod = tuple(a for a in ("pod",) if mesh.shape.get(a, 1) > 1)
    # forward, the recompute under remat, backward
    passes = ((2 if remat else 1) + 1) if train else 1
    ops: list[tuple[str, tuple, int]] = []

    def add(kind, axes, nbytes, times=1):
        if axes and all(mesh.shape[a] > 1 for a in axes):
            ops.extend([(kind, axes, nbytes)] * times)

    def tp_reduce(nbytes, times):
        if cfg.seq_parallel:
            add("reduce-scatter", (tp,), nbytes // mesh.shape[tp], times)
            add("all-gather", (tp,), nbytes, times)
        else:
            add("all-reduce", (tp,), nbytes, times)

    specs = dict(tree.flatten_with_names(args_sh[0]))
    for name, leaf in tree.flatten_with_names(params):
        if f"0/{name}" not in read:
            continue
        spec = tuple(specs[name]) + (None,) * (leaf.dim()
                                               - len(specs[name]))
        stacked = _is_layer_leaf(name)
        layers = leaf.shape[0] if stacked else 1
        shape, spec = (leaf.shape[1:], spec[1:]) if stacked \
            else (leaf.shape, spec)
        shard = _nbytes(shard_shape(shape, spec, plan), leaf.dtype)
        if any(fs in _axes(e) for e in spec):
            gathered = _nbytes(shard_shape(shape, spec, plan, drop=(fs,)),
                               leaf.dtype)
            regather = train and remat and stacked
            add("all-gather", (fs,), gathered,
                layers * (2 if regather else 1))
            if train:
                add("reduce-scatter", (fs,), shard, layers)
                add("all-reduce", pod, shard, layers)
        elif train:
            add("all-reduce", dp, shard, layers)

        short = name.rsplit("/", 1)[-1]
        if not (stacked and tp in _axes(spec[0])):
            continue
        if short == "wo" or (short == "w2" and leaf.dim() == 3):
            rows = seqs * cfg.enc_frames if name.startswith("enc_") \
                else tokens
            tp_reduce(rows * cfg.d_model * ACT_BYTES, layers * passes)
        elif short == "w2":                     # MoE (L, E, F, D)
            E = leaf.shape[1]
            C = moe_capacity(tokens, E, cfg.top_k, cfg.capacity_factor)
            add("all-to-all", (tp,), E * C * cfg.d_model * ACT_BYTES,
                2 * layers * passes)
    counts = {k: 0 for k in COLLECTIVES}
    for kind, _, _ in ops:
        counts[kind] += 1
    return counts, ops


def link_bandwidth(mesh, axes: tuple) -> float:
    """Bytes/s of one device along ``axes``: NVLink where the devices of
    the group lie in one 8-GPU node (the mesh laid out row-major, the
    last axis fastest, 8 consecutive devices a node), one InfiniBand port
    where they do not."""
    names = list(mesh.shape)
    first = min(names.index(a) for a in axes)
    span = math.prod(mesh.shape[a] for a in names[first:])
    if span <= H100_SXM["gpus_per_node"]:
        return H100_SXM["nvlink_bandwidth"]
    return H100_SXM["internode_bandwidth"]


# -- one cell ----------------------------------------------------------------

def _mesh_name(multi_pod: bool, mesh: str | None) -> str:
    if mesh is None:
        return "2x16x16" if multi_pod else "16x16"
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}: one of {sorted(MESHES)}")
    return mesh


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh: str | None = None, remat: bool = True,
               extra_config: dict | None = None, optimizer=None,
               accum_steps: int = 1, trace: Trace | None = None):
    """Trace one cell (or take ``trace``, a trace of the same cell from
    another mesh) and lay it over ``mesh`` (``card``, ``16x16`` or
    ``2x16x16``; default by ``multi_pod``).

    Returns ``(record, trace)``, the record with the reference's keys
    wherever a counterpart exists. ``roofline.flops_per_device`` is the
    traced total split evenly over the devices: the reference's
    partitioned count also holds the SSM internals, which the model
    axis replicates, so the two differ there."""
    cfg = get_config(arch)
    if extra_config:
        cfg = dataclasses.replace(cfg, **extra_config)
    name = _mesh_name(multi_pod, mesh)
    axis_mesh = MESHES[name]()
    shape = SHAPES[shape_name]
    plan = sh.make_plan(
        axis_mesh, shard_sequence=(shape_name == "long_500k"
                                   and cfg.family in ("ssm", "hybrid")))
    cell = build_cell(cfg, arch, shape_name, remat=remat,
                      optimizer=optimizer, accum_steps=accum_steps)
    n_devices = math.prod(axis_mesh.shape.values())
    record = {"arch": arch, "shape": shape_name, "kind": cell.kind,
              "mesh": name, "n_devices": n_devices}
    if cell.skip_reason:
        record["status"] = "skip"
        record["reason"] = cell.skip_reason
        return record, None

    if trace is None:
        trace = trace_cell(cell)
    record["trace_s"] = round(trace.seconds, 2)
    args_sh = argument_layouts(cell, plan)
    outs_sh = output_layouts(cell, plan, args_sh, trace.outputs)
    arg_bytes = layout_bytes(cell.arg_specs, args_sh, plan)
    on_card = name == "card"
    record["memory_analysis"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": layout_bytes(trace.outputs, outs_sh, plan),
        "alias_bytes": sum(layout_bytes(cell.arg_specs[i], args_sh[i], plan)
                           for i in cell.donate_argnums),
        "temp_bytes": trace.step_peak_bytes if on_card else None,
    }
    if on_card:
        peak = arg_bytes + trace.step_peak_bytes
        record["peak_bytes"] = peak
        record["fits_card"] = peak < H100_SXM["hbm_bytes"]
    else:
        record["memory_analysis"]["temp_reason"] = (
            "the port has no partitioner: what a device holds while the "
            "step runs is traced on the card mesh only")

    counts, ops = collective_schedule(cfg, cell, plan, trace.read,
                                      remat=remat)
    record["collective_schedule"] = counts
    by_axes: dict[tuple, int] = {}
    for _, axes, nbytes in ops:
        by_axes[axes] = by_axes.get(axes, 0) + nbytes
    record["collective_bytes_by_axes"] = {
        "+".join(a): b for a, b in by_axes.items()}

    opt_bytes = 12.0
    if optimizer is not None and optimizer.state_dtype == torch.bfloat16:
        opt_bytes = 8.0             # f32 params + bf16 m/v
    mem = memtraffic.analyze_memory(
        cfg, shape, n_devices=n_devices, dp=plan.dp_size,
        tp=axis_mesh.shape["model"], kind=cell.kind,
        accum_steps=accum_steps, opt_bytes_per_param=opt_bytes)
    record["fits_hbm"] = mem.fits_hbm
    record["hbm_residency_bytes"] = mem.residency_bytes
    record["memory_detail"] = mem.detail

    flops = trace.flops / n_devices
    cbytes = sum(by_axes.values())
    compute_s = flops / PEAK_FLOPS
    memory_s = mem.traffic_bytes / H100_SXM["hbm_bandwidth"]
    collective_s = sum(b / link_bandwidth(axis_mesh, axes)
                       for axes, b in by_axes.items())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    record["roofline"] = {
        "flops_per_device": flops,
        "bytes_per_device": mem.traffic_bytes,
        "collective_bytes_per_device": cbytes,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
    }
    mf = roofline_lib.model_flops(get_config(arch), shape,
                                  train=(cell.kind == "train"))
    record["model_flops_global"] = mf
    record["useful_flops_ratio"] = mf / trace.flops if trace.flops else 0.0
    bound = max(terms.values())
    record["roofline_fraction"] = (
        (mf / n_devices / PEAK_FLOPS) / bound if bound else 0.0)
    record["status"] = "ok"
    return record, trace


# -- SQL ---------------------------------------------------------------------

def dryrun_queries(sf: float = 0.01, out: str | None = None,
                   session=None) -> int:
    """Plan (never execute) all TPC-H queries; returns the failure count.

    ``session``: plan through this session and its catalog (one that
    already holds the data) instead of a new one; its invocation count
    must not move. A new session plans on the CPU: planning runs no
    fragment, so it needs no card."""
    from repro_torch.api import connect
    from repro_torch.sql.queries import QUERIES

    if session is None:
        session = connect(tier="local", device="cpu")
        session.ensure_tpch(sf=sf, n_parts=4)
    invoked = session.platform.invocations
    out_f = open(out, "a") if out else None
    failures = 0
    try:
        for qname, sql in QUERIES.items():
            try:
                text = session.explain(sql)
                n_pipes = text.splitlines()[0]
                print(f"[ok]   {qname}: {n_pipes}")
                rec = {"query": qname, "sf": sf, "status": "ok",
                       "plan": text}
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"[FAIL] {qname}: {e!r}")
                rec = {"query": qname, "sf": sf, "status": "error",
                       "error": repr(e)}
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
    finally:
        if out_f:
            out_f.close()
    if session.platform.invocations != invoked:
        raise AssertionError("dry-run invoked workers")
    return failures


# -- CLI ---------------------------------------------------------------------

def summary(tag: str, rec: dict) -> str:
    """One line of a record, as the CLI prints it."""
    if rec["status"] == "ok":
        r = rec["roofline"]
        line = (f"[ok]   {tag}: trace={rec['trace_s']}s "
                f"dominant={r['dominant']} "
                f"compute={r['compute_s']:.4f}s "
                f"memory={r['memory_s']:.4f}s "
                f"collective={r['collective_s']:.4f}s "
                f"roofline_frac={rec['roofline_fraction']:.3f}")
        if "fits_card" in rec:
            line += (f" peak={rec['peak_bytes'] / 1e9:.2f}GB "
                     f"fits_card={rec['fits_card']}")
        return line
    if rec["status"] == "skip":
        return f"[skip] {tag}: {rec['reason']}"
    return f"[FAIL] {tag}: {rec['error']}"


def run(archs, shapes, meshes, *, remat=True, extra_config=None,
        optimizer=None, accum_steps=1, out=None, emit=print) -> list[dict]:
    """Every (arch × shape × mesh) record, each (arch, shape) traced once;
    a cell whose trace raises is recorded with status ``error``."""
    records = []
    out_f = open(out, "a") if out else None
    try:
        for arch in archs:
            for shape in shapes:
                trace, error = None, None
                for name in meshes:
                    if error is None:
                        try:
                            rec, trace = lower_cell(
                                arch, shape, mesh=name, remat=remat,
                                extra_config=extra_config,
                                optimizer=optimizer,
                                accum_steps=accum_steps, trace=trace)
                        except Exception as e:  # noqa: BLE001
                            error = e
                            traceback.print_exc()
                    if error is not None:
                        rec = {"arch": arch, "shape": shape, "mesh": name,
                               "status": "error", "error": repr(error)}
                    emit(summary(f"{arch} × {shape} × {name}", rec))
                    records.append(rec)
                    if out_f:
                        out_f.write(json.dumps(rec) + "\n")
                        out_f.flush()
    finally:
        if out_f:
            out_f.close()
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron sequence parallelism")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation steps")
    ap.add_argument("--bf16-adam", action="store_true",
                    help="bf16 optimizer moments")
    ap.add_argument("--queries", action="store_true",
                    help="SQL mode: plan all TPC-H queries (no "
                         "execution) through a repro_torch.api session")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="TPC-H scale factor for --queries")
    args = ap.parse_args(argv)

    if args.queries:
        failures = dryrun_queries(sf=args.sf, out=args.out)
        if failures:
            raise SystemExit(f"{failures} query plans failed")
        return

    extra = {"seq_parallel": True} if args.seq_parallel else None
    optimizer = None
    if args.bf16_adam:
        from repro_torch.optim import AdamW
        optimizer = AdamW(state_dtype=torch.bfloat16)
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"], "card": ["card"]}[args.mesh]
    records = run(archs, shapes, meshes, remat=not args.no_remat,
                  extra_config=extra, optimizer=optimizer,
                  accum_steps=args.accum, out=args.out)
    failures = sum(r["status"] == "error" for r in records)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
