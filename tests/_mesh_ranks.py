"""One rank of the port's 2×2 mesh runs in ``tests/test_torch_mesh_*.py``:
four gloo ranks on a (data 2, model 2) CPU ``DeviceMesh``. Not a test
module; it imports no JAX.

    python tests/_mesh_ranks.py JOB OUT     (env RANK, WORLD_SIZE,
                                             MASTER_PORT)

``JOB`` is a pickle the test wrote: a list of cases, each an ``arch``, a
``task`` (train, forward, serve, collectives), the reference's
parameters as numpy arrays and the case's batch. Each rank lays them out
by the rule tables (``parallel/sharding.py``), runs the port's step over
the mesh, and rank 0 writes every result, gathered whole, as numpy
arrays, to ``OUT``; a case that raises records its traceback there.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import device_mesh, make_debug_mesh
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import sharding as sh

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


TASKS = {"train": run_train, "forward": run_forward, "serve": run_serve,
         "collectives": run_collectives}


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
