"""One rank of the port's 2×2 mesh runs in ``tests/test_torch_mesh_*.py``:
four gloo ranks on a (data 2, model 2) CPU ``DeviceMesh``. Not a test
module; it imports no JAX.

    python tests/_mesh_ranks.py JOB OUT     (env RANK, WORLD_SIZE,
                                             MASTER_PORT)

``JOB`` is a pickle the test wrote: a list of cases, each an ``arch``, a
``task`` (train, forward, serve, collectives, checkpoint, placements),
the reference's parameters as numpy arrays and the case's batch. Each
rank lays them out by the rule tables (``parallel/sharding.py``), runs
the port's step over the mesh, and rank 0 writes every result, gathered
whole, as numpy arrays, to ``OUT``; a case that raises records its
traceback there.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import tree
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import device_mesh, make_debug_mesh
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import sharding as sh
from repro_torch.storage import ObjectStore

F32 = torch.float32
TRAIN_STEPS = 5         # the trainer's schedule length, as in the tests
_funcol = torch.ops._c10d_functional
COLLECTIVE = {_funcol.all_gather_into_tensor: "all-gather",
              _funcol.all_reduce: "all-reduce",
              _funcol.reduce_scatter_tensor: "reduce-scatter",
              _funcol.all_to_all_single: "all-to-all"}


def trainer_optimizer() -> AdamW:
    """``launch/train.make_trainer``'s optimizer."""
    return AdamW(lr=cosine_schedule(3e-3, warmup=10, total=TRAIN_STEPS),
                 weight_decay=0.01)


def config(case):
    return dataclasses.replace(get_reduced(case["arch"]),
                               **case.get("overrides", {}))


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def numpy_tree(t):
    return tree.tree_map(lambda x: x.detach().numpy().copy(), t)


def layout_faults(plan, values, specs, prefix: str) -> list[str]:
    """Leaves that are not DTensors with their spec's placements."""
    out = []
    for (name, leaf), spec in zip(tree.flatten_with_names(values),
                                  tree.leaves(specs)):
        want = sh.placements(plan, spec)
        if not isinstance(leaf, DTensor):
            out.append(f"{prefix}/{name}: a {type(leaf).__name__}")
        elif tuple(leaf.placements) != want:
            out.append(f"{prefix}/{name}: {leaf.placements} != {want}")
    return out


class CommBytes(CommDebugMode):
    """``CommDebugMode`` that also keeps each collective's kind, the
    bytes of its output on this rank, and the tag set while it ran."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, str, int]] = []
        self.tag = "other"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = COLLECTIVE.get(getattr(func, "_overloadpacket", None))
        if kind is not None and out is not NotImplemented:
            self.ops.append((kind, self.tag, out.numel() * out.element_size()))
        return out


def run_train(mesh, plan, case):
    cfg = config(case)
    params = params_from_numpy(case["params"])
    p_specs = sh.param_shardings(plan, params)
    dp = sh.shard_tree(plan, params, p_specs)
    opt = trainer_optimizer()
    state = opt.init(dp)
    batch = tensors(case["batch"])
    db = sh.shard_tree(plan, batch, sh.batch_shardings(plan, batch))
    step = steps_lib.make_train_step(cfg, opt, mesh=mesh, compute_dtype=F32,
                                     accum_steps=case.get("accum", 1))
    dp, state, metrics = step(dp, state, db)
    o_specs = sh.opt_state_shardings(plan, params, state)
    faults = layout_faults(plan, dp, p_specs, "params") \
        + layout_faults(plan, state, o_specs, "opt")
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": numpy_tree(sh.gather_tree(dp)),
            "step": int(sh.gather_tree(state)["step"]),
            "faults": faults}


def run_forward(mesh, plan, case):
    cfg = config(case)
    params = params_from_numpy(case["params"])
    dp = sh.shard_tree(plan, params, sh.param_shardings(plan, params))
    batch = tensors(case["batch"])
    db = sh.shard_tree(plan, batch, sh.batch_shardings(plan, batch))
    logits = model_lib.forward(cfg, dp, db["tokens"], mesh=mesh,
                               compute_dtype=F32, frames=db.get("frames"))
    return {"logits": logits.full_tensor().numpy()}


def run_serve(mesh, plan, case):
    """Prefill over the prompt with room for two more tokens, then two
    serve steps; and the prefill step over the same prompt."""
    cfg = config(case)
    params = params_from_numpy(case["params"])
    p_specs = sh.param_shardings(plan, params)
    dp = sh.shard_tree(plan, params, p_specs)
    tokens = case["tokens"]
    S = case["S"]
    batch = tensors({"tokens": tokens[:, :S]} | (
        {"frames": case["frames"]} if case.get("frames") is not None
        else {}))
    db = sh.shard_tree(plan, batch, sh.batch_shardings(plan, batch))
    logits, cache = decode_lib.prefill(
        cfg, dp, db["tokens"], mesh=mesh, compute_dtype=F32,
        frames=db.get("frames"), max_len=S + 2)
    out = {"last": logits.full_tensor().numpy(),
           "cache0": numpy_tree(sh.gather_tree(cache))}
    faults = layout_faults(plan, dp, p_specs, "params") + layout_faults(
        plan, cache, sh.cache_shardings(plan, cache), "cache0")
    serve = steps_lib.make_serve_step(cfg, mesh=mesh, compute_dtype=F32)
    for i in (1, 2):
        tok = tensors({"tokens": tokens[:, S + i - 1]})
        tok = sh.shard_tree(plan, tok, sh.batch_shardings(plan, tok))
        nxt, logits, cache = serve(dp, cache, tok["tokens"])
        out[f"dec{i}"] = logits.numpy()
        out[f"next{i}"] = nxt.numpy()
        out[f"cache{i}"] = numpy_tree(sh.gather_tree(cache))
        faults += layout_faults(plan, cache,
                                sh.cache_shardings(plan, cache), f"cache{i}")
    step = steps_lib.make_prefill_step(cfg, mesh=mesh, compute_dtype=F32)
    logits, cache = step(dp, db)
    out["step_last"] = logits.numpy()
    faults += layout_faults(plan, cache, sh.cache_shardings(plan, cache),
                            "prefill_step")
    out["faults"] = faults
    return out


def run_collectives(mesh, plan, case):
    """One train step under ``CommBytes``, each collective that a weight's
    gather at use (``use_weight``, the embedding's included) issues
    tagged ``weight``."""
    cfg = config(case)
    params = params_from_numpy(case["params"])
    dp = sh.shard_tree(plan, params, sh.param_shardings(plan, params))
    opt = trainer_optimizer()
    state = opt.init(dp)
    batch = tensors(case["batch"])
    db = sh.shard_tree(plan, batch, sh.batch_shardings(plan, batch))
    step = steps_lib.make_train_step(cfg, opt, mesh=mesh, compute_dtype=F32)
    mode = CommBytes()
    inner, inner_swap = model_lib.use_weight, sh._swap_chunks

    def tagged(*args, **kwargs):
        before, mode.tag = mode.tag, "weight"
        try:
            return inner(*args, **kwargs)
        finally:
            mode.tag = before

    def swap(local, *args, **kwargs):
        # a point-to-point exchange, which CommDebugMode does not see
        out = inner_swap(local, *args, **kwargs)
        if out is not local:
            mode.ops.append(("collective-permute", mode.tag,
                             out.numel() * out.element_size()))
        return out
    model_lib.use_weight, sh._swap_chunks = tagged, swap
    try:
        with mode:
            step(dp, state, db)
    finally:
        model_lib.use_weight, sh._swap_chunks = inner, inner_swap
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mode.ops)
    counts = {str(k): v for k, v in mode.get_comm_counts().items()}
    return {"ops": every, "comm_counts": counts}


def objects(store: ObjectStore) -> dict[str, bytes]:
    return {k: store.get(k).data for k in store.list("")}


def store_of(objs: dict[str, bytes]) -> ObjectStore:
    store = ObjectStore(tier="local")
    for k, v in objs.items():
        store.put(k, v)
    return store


def saved(step: int, state) -> dict[str, bytes]:
    """The objects ``save_checkpoint`` writes for ``state`` at ``step``,
    into a store of their own (run ``run``)."""
    store = ObjectStore(tier="local")
    save_checkpoint(store, "run", step, state)
    return objects(store)


def differing(got: dict, want: dict) -> list[str]:
    """Keys not byte-identical between two stores' objects, or in one
    only."""
    return sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))


def wait_for(path: str, timeout: float = 600) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written in {timeout:.0f} s")
        time.sleep(0.2)


def run_checkpoint(mesh, plan, case):
    """A sharded state through the checkpoint store. Each rank saves
    (every rank calls ``save_checkpoint`` with its own shards) and
    compares its objects: the laid-out parameters' against the plain
    parameters' save, and after one train step the DTensor state's
    against the save of ``gather_tree(state)``. Then step 2 three ways
    from the step-1 state: uninterrupted; restored from this rank's
    objects (a DTensor template), laid out by ``shard_tree`` with the
    run's specs; and from the reference's step-1 objects of its own
    sharded run (``case["ref_ckpt"]``, written by
    ``tests/_mesh_reference.py``)."""
    cfg = config(case)
    params = params_from_numpy(case["params"])
    p_specs = sh.param_shardings(plan, params)
    dp = sh.shard_tree(plan, params, p_specs)
    laid_vs_plain = differing(saved(0, dp), saved(0, params))
    opt = trainer_optimizer()
    state = opt.init(dp)
    specs = {"params": p_specs,
             "opt": sh.opt_state_shardings(plan, params, state)}
    b1, b2 = (sh.shard_tree(plan, b, sh.batch_shardings(plan, b))
              for b in (tensors(case["batch"]), tensors(case["batch2"])))
    step = steps_lib.make_train_step(cfg, opt, mesh=mesh, compute_dtype=F32)
    dp, state, _ = step(dp, state, b1)
    sharded = {"params": dp, "opt": state}
    got = saved(1, sharded)
    whole = numpy_tree(sh.gather_tree(sharded))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {
        "laid_vs_plain": laid_vs_plain,
        "sharded_vs_gathered": differing(got, saved(1, sh.gather_tree(
            sharded)))})

    def step2(start, name):
        """Step 2 from ``start`` (in place); its metrics, state (whole)
        and layout faults before and after."""
        faults = layout_faults(plan, start, specs, f"{name}/restored")
        p, st, m = step(start["params"], start["opt"], b2)
        out = {"params": p, "opt": st}
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "state": numpy_tree(sh.gather_tree(out)),
                "faults": faults + layout_faults(plan, out, specs, name)}

    def restored(objs):
        back, at = load_checkpoint(store_of(objs), "run", sharded)
        assert at == 1 and not any(isinstance(t, DTensor)
                                   for t in tree.leaves(back))
        return sh.shard_tree(plan, back, specs)
    resumed = step2(restored(got), "resumed")
    whole_run = step2(sharded, "uninterrupted")
    wait_for(case["ref_ckpt"])
    with open(case["ref_ckpt"], "rb") as f:
        ref_objects = pickle.load(f)
    return {"ranks": every, "objects": got, "step1": whole,
            "resumed": resumed, "uninterrupted": whole_run,
            "from_reference": step2(restored(ref_objects),
                                    "from_reference")}


def run_placements(mesh, plan, case):
    """``case["tree"]`` laid out by the specs of ``case["spec_entries"]``
    (``sharding.P(*entries)``): each rank's save of it against its plain
    save, and its coordinate and local shards."""
    # (``tensors`` would make a 0-d leaf 1-d: np.ascontiguousarray)
    plain = {k: torch.from_numpy(v.copy()) for k, v in case["tree"].items()}
    specs = {k: sh.P(*v) for k, v in case["spec_entries"].items()}
    laid = sh.shard_tree(plan, plain, specs)
    got = saved(0, laid)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {
        "coordinate": mesh.get_coordinate(),
        "differing": differing(got, saved(0, plain)),
        "local": {k: v.to_local().numpy().copy() for k, v in laid.items()}})
    return {"ranks": every, "objects": got,
            "placements": {k: tuple(map(repr, v.placements))
                           for k, v in laid.items()}}


TASKS = {"train": run_train, "forward": run_forward, "serve": run_serve,
         "collectives": run_collectives, "checkpoint": run_checkpoint,
         "placements": run_placements}


def main(job_path: str, out_path: str) -> int:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    # a rank that raised leaves the others waiting in a collective: they
    # give up after the timeout instead of the default half hour
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]), rank=rank,
        timeout=datetime.timedelta(seconds=300))
    results = {}
    try:
        mesh = device_mesh(make_debug_mesh(2, 2), "cpu")
        plan = sh.make_plan(mesh)
        with open(job_path, "rb") as f:
            cases = pickle.load(f)
        for case in cases:
            results[case["name"]] = {"error": "not run"}
            results[case["name"]] = TASKS[case["task"]](mesh, plan, case)
        try:
            device_mesh(make_debug_mesh(1, 2), "cpu")
            results["_refusal"] = None
        except ValueError as e:
            results["_refusal"] = str(e)
        return 0
    except Exception:
        name = next(reversed(results), "_setup")
        results[name] = {"error": traceback.format_exc()}
        return 1
    finally:
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
