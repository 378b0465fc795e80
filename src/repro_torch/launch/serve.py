"""Batched serving: prefill + KV-cache decode loop — the port of
``repro.launch.serve``, on the CUDA card unless asked for the CPU.

Serving is the paper's interactive-query story transplanted to LMs: a
stateless "coordinator" receives a batch of requests, runs prefill (the
scan-heavy stage), then streams decode steps (the small recurring
queries), with the cache as the intermediate result. The parameters are
random, drawn on the serving device from a seeded generator; the prompts
come from ``np.random.default_rng(0)``, as the reference's do.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --batch 4 --prompt-len 64 --new-tokens 32            # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.exec.batch import resolve_device
from repro_torch.models.decode import prefill
from repro_torch.models.model import init_params
from repro_torch.models.steps import make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_serving(*, arch: str, reduced: bool = True, batch: int = 4,
                prompt_len: int = 64, new_tokens: int = 32,
                verbose: bool = True, device=None,
                trace: dict | None = None):
    """Serve one batch: prefill the prompts, then ``new_tokens - 1``
    greedy decode steps. ``device``: the card unless given (see
    ``exec.batch.resolve_device``; no card and no device raises).
    ``trace``, where given, is filled with the config, the parameters,
    the prompts (and frames), the prefill logits and the first decode
    step's logits, for a caller that checks them."""
    device = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(device)
    frames = None
    if cfg.enc_dec:
        frames = torch.from_numpy(rng.normal(
            0, 1, (batch, cfg.enc_frames, cfg.d_model)).astype(
                np.float32)).to(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, prompts, frames=frames,
                            compute_dtype=torch.float32,
                            max_len=prompt_len + new_tokens)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    serve_step = make_serve_step(cfg, compute_dtype=torch.float32)
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    generated = [tokens]
    first_logits = None
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        tokens, step_logits, cache = serve_step(params, cache, tokens)
        if first_logits is None:
            first_logits = step_logits
        generated.append(tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0
    out = torch.stack(generated, dim=1)
    tps = batch * (new_tokens - 1) / max(t_decode, 1e-9)
    if verbose:
        print(f"[serve] arch={arch} batch={batch} prompt={prompt_len} "
              f"new={new_tokens}")
        print(f"[serve] prefill {t_prefill * 1e3:.1f} ms; decode "
              f"{t_decode * 1e3:.1f} ms ({tps:.1f} tok/s incl. compile)")
        print(f"[serve] sample continuation ids: "
              f"{out[0, :10].cpu().tolist()}")
    if trace is not None:
        trace.update(cfg=cfg, params=params, prompts=prompts, frames=frames,
                     prefill_logits=logits, decode_logits=first_logits)
    return out, {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tokens_per_s": tps}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card by default; "
                         "'cpu' runs it on the CPU")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e} (serve takes --device cpu)")
    if device.type == "cuda":
        print(f"[serve] device {device} "
              f"({torch.cuda.get_device_name(device)})")
    run_serving(arch=args.arch, reduced=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                device=device)


if __name__ == "__main__":
    main()
