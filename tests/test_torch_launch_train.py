"""The port's training driver (``launch/train.py``) against the
reference's, on the CPU at reduced configs.

The reference trains to an injected failure, leaving a stage checkpoint
in its store; both packages resume from that checkpoint (the port's
store holds a copy of the reference's objects) and their remaining
losses must agree within 1e-5 relative. The port's own fail-and-resume
must give the uninterrupted run's losses (within 1e-6) and parameters.
The batches are the reference's numpy stream, and ``python -m
repro_torch.launch.train --device cpu`` runs as a subprocess; without a
device argument on a machine with no card it raises (or exits nonzero)
before it builds anything.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.storage import ObjectStore as JStore
import repro_torch
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import store as tstore
from repro_torch.launch import train as ttrain
from repro_torch.launch.specs import params_specs
from repro_torch.optim import AdamW
from repro_torch.storage import ObjectStore as TStore

SRC = Path(repro_torch.__file__).resolve().parents[1]
RUN = dict(reduced=True, steps=4, stage_steps=2, batch=4, seq=32,
           verbose=False)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-large-v3"])
def test_both_packages_resume_the_references_stage_checkpoint(
        arch, monkeypatch):
    js = JStore(tier="local")
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        jtrain.run_training(arch=arch, store=js, run="r", fail_at_step=2,
                            **RUN)
    assert jtrain.latest_step(js, "r") == 2
    ts = TStore(tier="local")
    for key in js.list(""):
        ts.put(key, js.get(key).data)
    want, _ = jtrain.run_training(arch=arch, store=js, run="r", **RUN)
    moved = {"restore": [], "save": []}

    def nbytes(state):
        return sum(t.numel() * t.element_size() for t in tree.leaves(state))

    def load(*a, **k):
        state, step = tstore.load_checkpoint(*a, **k)
        moved["restore"].append(nbytes(state))
        return state, step

    def save(store, run, step, state):
        moved["save"].append(nbytes(state))
        return tstore.save_checkpoint(store, run, step, state)

    monkeypatch.setattr(ttrain, "load_checkpoint", load)
    monkeypatch.setattr(ttrain, "save_checkpoint", save)
    got, params = ttrain.run_training(arch=arch, store=ts, run="r",
                                      device="cpu", **RUN)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (arch, got, want)
    # one restore and one save, each of the parameters, their two float32
    # moments and the int32 step
    assert moved["restore"] == moved["save"] == [3 * nbytes(params) + 4]
    assert tstore.latest_step(ts, "r") == 4


def test_synthetic_batch_is_the_references():
    for arch in ("granite-3-2b", "whisper-large-v3"):
        cj, ct = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        for step in (0, 3):
            want = jtrain.synthetic_batch(cj, step, 3, 16)
            got = ttrain.synthetic_batch(ct, step, 3, 16, "cpu")
            assert sorted(got) == sorted(want)
            for k in want:
                w = np.asarray(want[k])
                assert got[k].numpy().dtype == w.dtype
                np.testing.assert_array_equal(got[k].numpy(), w)


def test_fail_and_resume_equals_the_uninterrupted_run():
    run = dict(RUN, steps=5)
    whole, wparams = ttrain.run_training(arch="hymba-1.5b", device="cpu",
                                         store=TStore(tier="local"), **run)
    ts = TStore(tier="local")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        ttrain.run_training(arch="hymba-1.5b", device="cpu", store=ts,
                            run="r", fail_at_step=3, **run)
    assert tstore.latest_step(ts, "r") == 2
    rest, params = ttrain.run_training(arch="hymba-1.5b", device="cpu",
                                       store=ts, run="r", **run)
    assert len(rest) == 3
    for g, w in zip(rest, whole[2:]):
        assert abs(g - w) <= 1e-6 * abs(w), (rest, whole)
    cfg = tconfigs.get_reduced("hymba-1.5b")
    template = {"params": params_specs(cfg)}
    template["opt"] = AdamW().init(template["params"])
    state, step = tstore.load_checkpoint(ts, "r", template)
    assert step == 5
    for a, b, c in zip(tree.leaves(state["params"]), tree.leaves(params),
                       tree.leaves(wparams)):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_without_a_device_and_no_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is to use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_training(arch="granite-3-2b", **RUN)
    res = _cli("--reduced", "--steps", "1", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "--device cpu" in res.stderr
    assert "[train]" not in res.stdout


def _cli(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC), **env))


def test_cli_on_the_cpu():
    res = _cli("--device", "cpu", "--reduced", "--steps", "2",
               "--stage-steps", "1", "--batch", "2", "--seq", "16")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert [ln.split(" loss=")[0] for ln in lines[:2]] == \
        ["[train] stage complete @ step 1", "[train] stage complete @ step 2"]
    assert lines[2].startswith("[train] done: loss ")
