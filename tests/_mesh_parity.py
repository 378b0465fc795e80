"""Shared cases of ``tests/test_torch_mesh_{train,serve}.py``: the port's
steps over a 2×2 (data, model) mesh of four gloo ranks on the CPU, held
against the reference's steps jitted over ``make_debug_mesh(2, 2)`` and
against the port's own steps without a mesh. Not a test module.

``MeshRun`` writes one job (every case of a file: its arch, the
reference's parameters as numpy arrays, its batch) and starts both sides
at once: four ranks of ``tests/_mesh_ranks.py`` (no JAX) and one
``tests/_mesh_reference.py`` (JAX, four host devices), each a
subprocess, while the test computes the port's unsharded results.
Parameters come from the reference's ``init_params`` once an arch,
converted by ``models/convert.py``; batches from a numpy seed; every
step computes in float32.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np

from repro import configs as jconfigs
from repro.models import model as jmodel

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
WORLD = 4
B, S = 4, 32
LOSS_REL = 1e-5       # loss and grad_norm, relative
LEAF_REL = 1e-4       # each tensor, of its largest reference value
ILL = 100             # an AdamW denominator below ILL · eps: ill-conditioned
ARCHS = ["granite-3-2b", "chatglm3-6b", "llama3-405b", "nemotron-4-15b",
         "mamba2-130m", "hymba-1.5b", "qwen3-moe-235b-a22b",
         "granite-moe-1b-a400m", "chameleon-34b", "whisper-large-v3"]


def reference_params(arch: str, **overrides) -> dict:
    import dataclasses
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), **overrides)
    return jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.PRNGKey(1)))


def train_batch(arch: str, seed: int, batch: int = B, seq: int = S) -> dict:
    cfg = jconfigs.get_reduced(arch)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.enc_dec:
        out["frames"] = rng.normal(
            0, 1, (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MeshRun:
    """Both sides of one file's cases, started together."""

    def __init__(self, cases: list[dict], tmp: Path):
        self.tmp = tmp
        job = tmp / "job.pkl"
        with open(job, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", WORLD_SIZE=str(WORLD),
                   MASTER_PORT=str(_free_port()))
        self.logs = []
        self.ranks = []
        for r in range(WORLD):
            log = open(tmp / f"rank{r}.log", "w")
            self.logs.append(log)
            self.ranks.append(subprocess.Popen(
                [sys.executable, str(TESTS / "_mesh_ranks.py"), str(job),
                 str(tmp / "port.pkl")], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT, env=dict(env, RANK=str(r))))
        self.ref = None
        if any(c.get("ref") for c in cases):
            log = open(tmp / "reference.log", "w")
            self.logs.append(log)
            self.ref = subprocess.Popen(
                [sys.executable, str(TESTS / "_mesh_reference.py"), str(job),
                 str(tmp / "ref.pkl")], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    def wait(self, timeout: float = 600) -> tuple[dict, dict]:
        """(the ranks' results, the reference's), each by case name."""
        deadline = time.monotonic() + timeout
        procs = self.ranks + ([self.ref] if self.ref else [])
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        port = self._load("port.pkl", "rank0.log")
        ref = self._load("ref.pkl", "reference.log") if self.ref else {}
        return port, ref

    def _load(self, name: str, log: str) -> dict:
        path = self.tmp / name
        if not path.exists():
            raise AssertionError(f"{name} not written:\n"
                                 + (self.tmp / log).read_text()[-4000:])
        with open(path, "rb") as f:
            return pickle.load(f)


def result(results: dict, name: str) -> dict:
    """A case's result; a case that raised fails with its traceback."""
    r = results.get(name)
    assert r is not None, f"{name}: no result"
    assert "error" not in r, f"{name}:\n{r['error']}"
    return r


def max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not got.size:
        return 0.0
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def tree_rel(got: dict, want: dict) -> dict:
    """``max_rel`` of each leaf of two trees of one structure, by name."""
    from repro_torch import tree
    g, w = tree.flatten_with_names(got), tree.flatten_with_names(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    return {n: max_rel(a, b) for (n, a), (_, b) in zip(g, w)}


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def leaf_errors(got: dict, want: dict, ill: list):
    """Per leaf: the largest error over its well-conditioned elements, of
    its largest value; and the largest over its ill-conditioned ones
    (``ill``: a boolean mask a leaf)."""
    from repro_torch import tree
    well, rest = [], []
    for a, b, m in zip(tree.leaves(got), tree.leaves(want), ill):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b)
        scale = max(float(np.abs(b).max()), 1e-30) if b.size else 1.0
        well.append(float(err[~m].max()) / scale if (~m).any() else 0.0)
        rest.append(float(err[m].max()) if m.any() else 0.0)
    return well, rest
