"""The port's serving path (``models/steps.py``, ``launch/serve.py``) on
the CPU: on the reference's parameters (converted through
``models/convert.py``), prefill and a greedy ``make_serve_step`` loop
give the reference's token ids exactly, for granite's and mamba2's
reduced configs; ``python -m repro_torch.launch.serve --device cpu``
prints the reference's lines; without ``--device cpu`` on a machine with
no card it exits non-zero before it builds anything."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.models import steps as jsteps

import repro_torch
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdecode
from repro_torch.models import steps as tsteps
from repro_torch.models.convert import params_from_numpy

SRC = Path(repro_torch.__file__).resolve().parents[1]
B, PROMPT, NEW = 4, 24, 12


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_greedy_ids_match_reference(arch):
    cfg_j, cfg_t = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    params_j = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j))
    prompts = np.random.default_rng(0).integers(
        0, cfg_j.vocab, (B, PROMPT)).astype(np.int32)

    logits, cache = jdecode.prefill(cfg_j, params_j, jnp.asarray(prompts),
                                    compute_dtype=jnp.float32,
                                    max_len=PROMPT + NEW)
    step = jax.jit(jsteps.make_serve_step(cfg_j, compute_dtype=jnp.float32))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(NEW - 1):
        tok, _, cache = step(params_j, cache, tok)
        want.append(np.asarray(tok))

    logits, cache = tdecode.prefill(cfg_t, params_t,
                                    torch.from_numpy(prompts),
                                    compute_dtype=torch.float32,
                                    max_len=PROMPT + NEW)
    step = tsteps.make_serve_step(cfg_t, compute_dtype=torch.float32)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    got = [tok.numpy()]
    for _ in range(NEW - 1):
        tok, _, cache = step(params_t, cache, tok)
        assert tok.dtype == torch.int32
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    assert int(cache["pos"]) == PROMPT + NEW - 1


def test_loss_matches_reference():
    cfg_j = jconfigs.get_reduced("granite-3-2b")
    params_j = jmodel.init_params(cfg_j, jax.random.PRNGKey(3))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j))
    tokens = np.random.default_rng(3).integers(
        0, cfg_j.vocab, (2, 16)).astype(np.int32)
    want = jsteps.make_loss_fn(cfg_j, compute_dtype=jnp.float32)(
        params_j, {"tokens": jnp.asarray(tokens),
                   "labels": jnp.asarray(tokens)})
    t = torch.from_numpy(tokens)
    got = tsteps.make_loss_fn(tconfigs.get_reduced("granite-3-2b"),
                              compute_dtype=torch.float32)(
        params_t, {"tokens": t, "labels": t.long()})
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def _shape(text):
    """The printed lines with every number replaced by ``#``."""
    return [re.sub(r"\d+(\.\d+)?", "#", line)
            for line in text.splitlines() if line.startswith("[serve]")]


def test_run_serving_prints_the_reference_lines(capsys):
    kw = dict(arch="hymba-1.5b", batch=2, prompt_len=8, new_tokens=4)
    jserve.run_serving(**kw)
    want = capsys.readouterr().out
    out, stats = tserve.run_serving(device="cpu", **kw)
    got = capsys.readouterr().out
    assert _shape(got) == _shape(want) and len(_shape(got)) == 3, got
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert set(stats) == {"prefill_s", "decode_s", "tokens_per_s"}


def _cli(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC), **env))


def test_cli_on_the_cpu():
    res = _cli("--device", "cpu", "--batch", "2", "--prompt-len", "8",
               "--new-tokens", "3")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "[serve] arch=granite-3-2b batch=2 prompt=8 new=3"
    assert lines[1].startswith("[serve] prefill ")
    assert lines[2].startswith("[serve] sample continuation ids: [")


def test_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is to use it")
    res = _cli("--new-tokens", "2", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "--device cpu" in res.stderr
    assert "[serve] arch=" not in res.stdout
