"""Elastic training driver on the serverless runtime model — the port of
``repro.launch.train``, on the CUDA card unless asked for the CPU.

Training is expressed as a recurring "query": each *stage* is K optimizer
steps; stage results (checkpoints) are content-addressed objects in the
store; a restarted driver resumes from the last complete stage — the
same idempotent, storage-checkpointed execution model the SQL
coordinator uses for pipelines. Stage-level fault injection
(``fail_at_step``) exercises the recovery path.

The parameters are random, drawn on the training device from
``torch.Generator(device).manual_seed(0)``; the batches come from the
reference's numpy stream (``synthetic_batch``), so a step's data is the
same in both packages. A resumed run restores into a template of
parameter and optimizer shapes on the ``meta`` device
(``launch/specs.params_specs``), so it draws no second set of
parameters.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 3                                           # the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 60 --stage-steps 20 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_config, get_reduced
from repro_torch.exec.batch import resolve_device
from repro_torch.launch.specs import params_specs
from repro_torch.models.model import init_params
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.storage import ObjectStore


def synthetic_batch(cfg, step: int, batch: int, seq: int, device=None):
    """Deterministic per-step token stream (idempotent re-execution):
    the reference's numpy draws, as tensors on ``device``."""
    rng = np.random.default_rng((1234, step))
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out = {"tokens": torch.from_numpy(tokens).to(device),
           "labels": torch.from_numpy(
               np.roll(tokens, -1, axis=1)).to(device)}
    if cfg.enc_dec:
        out["frames"] = torch.from_numpy(rng.normal(
            0, 1, (batch, cfg.enc_frames, cfg.d_model)).astype(
                np.float32)).to(device)
    return out


def make_trainer(cfg, *, steps: int, lr: float = 3e-3,
                 accum_steps: int = 1):
    """The optimizer and the float32 train step (remat on) that
    ``run_training`` uses."""
    opt = AdamW(lr=cosine_schedule(lr, warmup=10, total=steps),
                weight_decay=0.01)
    return opt, make_train_step(cfg, opt, compute_dtype=torch.float32,
                                accum_steps=accum_steps)


def run_training(*, arch: str, reduced: bool, steps: int,
                 stage_steps: int, batch: int, seq: int,
                 store: ObjectStore | None = None, run: str | None = None,
                 lr: float = 3e-3, fail_at_step: int | None = None,
                 verbose: bool = True, device=None):
    """Train ``steps`` steps from the run's last stage checkpoint (or from
    step 0), writing one after every ``stage_steps``. Returns the losses
    of the steps it ran and the parameters. ``device``: the card unless
    given (``exec.batch.resolve_device``; no card and no device raises)."""
    device = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    store = store or ObjectStore(tier="local")
    run = run or f"{arch}-demo"
    opt, step_fn = make_trainer(cfg, steps=steps, lr=lr)

    start = latest_step(store, run)
    if start is not None:
        template = {"params": params_specs(cfg), "opt": None}
        template["opt"] = opt.init(template["params"])
        state, start = load_checkpoint(store, run, template, device=device)
        params, opt_state = state["params"], state["opt"]
        if verbose:
            print(f"[train] resumed {run} from stage checkpoint "
                  f"step={start}")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen)
        opt_state = opt.init(params)
        start = 0

    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch_data = synthetic_batch(cfg, step, batch, seq, device)
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        losses.append(float(metrics["loss"]))
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        if (step + 1) % stage_steps == 0 or step + 1 == steps:
            save_checkpoint(store, run, step + 1,
                            {"params": params, "opt": opt_state})
            if verbose:
                rate = (step + 1 - start) / (time.perf_counter() - t0)
                print(f"[train] stage complete @ step {step + 1} "
                      f"loss={losses[-1]:.4f} steps/s={rate:.2f}")
    return losses, params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--stage-steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="where the model trains: the CUDA card by default; "
                         "'cpu' trains it on the CPU")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[train] {e} (train takes --device cpu)")
    if device.type == "cuda":
        print(f"[train] device {device} "
              f"({torch.cuda.get_device_name(device)})")
    losses, _ = run_training(
        arch=args.arch, reduced=args.reduced, steps=args.steps,
        stage_steps=args.stage_steps, batch=args.batch, seq=args.seq,
        lr=args.lr, device=device)
    print(f"[train] done: loss {losses[0]:.4f} → {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
