"""The reference's side of ``tests/test_torch_mesh_*.py``: its steps
jitted over ``make_debug_mesh(2, 2)`` with the rule tables' in- and
out-shardings, and the same steps without a mesh, on four host devices.
Not a test module.

    python tests/_mesh_reference.py JOB OUT

``JOB`` is the pickle the test wrote (``tests/_mesh_ranks.py`` reads the
same one); only the cases marked ``ref`` run here, all in float32. For
each, ``OUT`` gets the sharded results under ``mesh`` and the unsharded
ones under ``plain``, as numpy arrays (a checkpoint case runs on the
mesh only, and also writes its step-1 objects to ``case["ref_ckpt"]``).
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_reduced  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models import decode, model, steps  # noqa: E402
from repro.optim import AdamW, cosine_schedule  # noqa: E402
from repro.parallel import sharding as sh  # noqa: E402
from repro.storage import ObjectStore  # noqa: E402

F32 = dict(compute_dtype=jnp.float32)
TRAIN_STEPS = 5


def numpy_tree(t):
    return jax.tree.map(np.asarray, t)


def _train_step(cfg, case, mesh):
    """The trainer's optimizer, the case's parameters and first batch,
    the optimizer state and the jitted step (with the rule tables'
    shardings on a mesh, then also the state's)."""
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=10, total=TRAIN_STEPS),
                weight_decay=0.01)
    params = jax.tree.map(jnp.asarray, case["params"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    fn = steps.make_train_step(cfg, opt, mesh=mesh,
                               accum_steps=case.get("accum", 1), **F32)
    state = opt.init(params)
    if mesh is None:
        return params, state, batch, jax.jit(fn), None
    plan = sh.make_plan(mesh)
    in_sh = (sh.param_shardings(plan, params),
             sh.opt_state_shardings(plan, params, state),
             sh.batch_shardings(plan, batch))
    step = jax.jit(fn, in_shardings=in_sh,
                   out_shardings=(in_sh[0], in_sh[1], None))
    return params, state, batch, step, {"params": in_sh[0],
                                        "opt": in_sh[1]}


def train(cfg, case, mesh):
    params, state, batch, step, _ = _train_step(cfg, case, mesh)
    p, _, m = step(params, state, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": numpy_tree(p)}


def checkpoint(cfg, case, mesh):
    """One sharded step, its sharded state saved by the reference's store
    (run ``run``) and the objects written to ``case["ref_ckpt"]``, renamed
    into place for the ranks that wait on it; then that checkpoint
    restored, put in the same shardings, and step 2 on ``batch2``."""
    params, state, batch, step, state_sh = _train_step(cfg, case, mesh)
    p, st, _ = step(params, state, batch)
    store = ObjectStore(tier="local")
    jstore.save_checkpoint(store, "run", 1, {"params": p, "opt": st})
    tmp = case["ref_ckpt"] + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({k: store.get(k).data for k in store.list("")}, f)
    os.replace(tmp, case["ref_ckpt"])
    back, _ = jstore.load_checkpoint(store, "run", {"params": p, "opt": st})
    back = jax.device_put(back, state_sh)
    batch2 = {k: jnp.asarray(v) for k, v in case["batch2"].items()}
    p, _, m = step(back["params"], back["opt"], batch2)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": numpy_tree(p)}


def forward(cfg, case, mesh):
    params = jax.tree.map(jnp.asarray, case["params"])
    tokens = jnp.asarray(case["batch"]["tokens"])
    fn = jax.jit(lambda p, t: model.forward(cfg, p, t, mesh=mesh, **F32))
    return {"logits": np.asarray(fn(params, tokens))}


def serve(cfg, case, mesh):
    params = jax.tree.map(jnp.asarray, case["params"])
    S, tokens = case["S"], case["tokens"]
    batch = {"tokens": jnp.asarray(tokens[:, :S])}
    if case.get("frames") is not None:
        batch["frames"] = jnp.asarray(case["frames"])

    def pre(p, b):
        return decode.prefill(cfg, p, b["tokens"], mesh=mesh,
                              frames=b.get("frames"), max_len=S + 2, **F32)

    def dec(p, c, t):
        return decode.decode_step(cfg, p, c, t, mesh=mesh, **F32)
    if mesh is None:
        pre, dec = jax.jit(pre), jax.jit(dec)
    else:
        plan = sh.make_plan(mesh)
        p_sh = sh.param_shardings(plan, params)
        cache_sh = sh.cache_shardings(plan, jax.eval_shape(pre, params,
                                                           batch)[1])
        pre = jax.jit(pre, in_shardings=(p_sh, sh.batch_shardings(
            plan, batch)), out_shardings=(None, cache_sh))
        tok_sh = sh.batch_shardings(plan, {"t": batch["tokens"][:, 0]})["t"]
        dec = jax.jit(dec, in_shardings=(p_sh, cache_sh, tok_sh),
                      out_shardings=(None, cache_sh))
    last, cache = pre(params, batch)
    out = {"last": np.asarray(last), "cache0": numpy_tree(cache)}
    for i in (1, 2):
        logits, cache = dec(params, cache, jnp.asarray(tokens[:, S + i - 1]))
        out[f"dec{i}"] = np.asarray(logits)
        out[f"cache{i}"] = numpy_tree(cache)
    return out


TASKS = {"train": train, "forward": forward, "serve": serve,
         "checkpoint": checkpoint}
MESH_ONLY = {"checkpoint"}


def main(job_path: str, out_path: str) -> None:
    with open(job_path, "rb") as f:
        cases = pickle.load(f)
    mesh = make_debug_mesh(2, 2)
    out = {}
    for case in cases:
        if not case.get("ref"):
            continue
        cfg = dataclasses.replace(get_reduced(case["arch"]),
                                  **case.get("overrides", {}))
        run = TASKS[case["task"]]
        with mesh:
            sharded = run(cfg, case, mesh)
        out[case["name"]] = {"mesh": sharded} if case["task"] in MESH_ONLY \
            else {"mesh": sharded, "plain": run(cfg, case, None)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
