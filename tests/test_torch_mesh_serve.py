"""The port's serving path over a 2×2 (data, model) device mesh — four
gloo ranks on the CPU, DTensors laid out by the rule tables — against
the reference's prefill and decode steps jitted over
``make_debug_mesh(2, 2)`` (the cache in and out by ``cache_shardings``)
and against the port's own steps without a mesh
(``tests/_mesh_parity.py``).

Each case prefills a 32-token prompt (batch 4) with room for two more
tokens, then takes two serve steps. The last prefill logits, each decode
step's logits and the cache after each step must lie within 1e-4 of the
largest reference value; where the reference's own sharded steps differ
from its unsharded ones by more than that for a config, twice the
reference's gap (each case prints its bar). Every parameter and cache
leaf over the mesh must be a DTensor with the rule tables' placements.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _mesh_ranks as ranks
from _mesh_parity import (ARCHS, LEAF_REL, S, MeshRun, max_rel,
                          reference_params, result, train_batch)
from repro_torch.launch.mesh import card_mesh, device_mesh
from repro_torch.models import decode as tdecode
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.steps import make_prefill_step

REF_ARCHS = ["granite-3-2b", "qwen3-moe-235b-a22b", "hymba-1.5b",
             "whisper-large-v3"]
CACHE_KEYS = ("k", "v", "ssm_state", "conv_state", "cross_k", "cross_v")
STEPS = ("last", "dec1", "dec2")
F32 = torch.float32


def _cases() -> list[dict]:
    cases = []
    for arch in ARCHS:
        batch = train_batch(arch, 3, seq=S + 2)
        cases.append(dict(name=f"serve-{arch}", arch=arch, task="serve",
                          params=reference_params(arch), S=S,
                          tokens=batch["tokens"], frames=batch.get("frames"),
                          ref=True))
    return cases


def _port_unsharded(case) -> dict:
    cfg = ranks.config(case)
    params = params_from_numpy(case["params"])
    tok = torch.from_numpy(case["tokens"])
    frames = None if case["frames"] is None \
        else torch.from_numpy(case["frames"])
    out = {}
    out["last"], cache = tdecode.prefill(cfg, params, tok[:, :S],
                                         frames=frames, max_len=S + 2,
                                         compute_dtype=F32)
    out["cache0"] = cache
    for i in (1, 2):
        out[f"dec{i}"], cache = tdecode.decode_step(
            cfg, params, cache, tok[:, S + i - 1], compute_dtype=F32)
        out[f"cache{i}"] = cache
    batch = {"tokens": tok[:, :S]} | ({} if frames is None
                                      else {"frames": frames})
    out["step_last"], _ = make_prefill_step(cfg, compute_dtype=F32)(params,
                                                                    batch)
    return ranks.numpy_tree(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    run = MeshRun(cases, tmp_path_factory.mktemp("mesh_serve"))
    plain = {c["name"]: _port_unsharded(c) for c in cases}
    port, ref = run.wait()
    return {"port": port, "ref": ref, "plain": plain}


def _gap(ref_case) -> float:
    """The reference's own sharded-versus-unsharded gap over the logits
    and caches of every step."""
    mesh, plain = ref_case["mesh"], ref_case["plain"]
    gaps = [max_rel(mesh[k], plain[k]) for k in STEPS]
    for step in ("cache0", "cache1", "cache2"):
        gaps += [max_rel(mesh[step][k], plain[step][k])
                 for k in CACHE_KEYS if k in plain[step]]
    return max(gaps)


def _check_serving(got, want, bar, ctx):
    print(f"{ctx}: bar {bar:.3g}")
    for k in STEPS:
        assert max_rel(got[k], want[k]) <= bar, (ctx, k)
    for step in ("cache0", "cache1", "cache2"):
        g, w = got[step], want[step]
        assert sorted(g) == sorted(w), (ctx, step, sorted(g), sorted(w))
        for k in CACHE_KEYS:
            if k in w:
                assert max_rel(g[k], w[k]) <= bar, (ctx, step, k)
        assert int(g["pos"]) == int(w["pos"]) == S + int(step[-1]), \
            (ctx, step)


def _bar(ref_case) -> float:
    gap = _gap(ref_case)
    return 2 * gap if gap > LEAF_REL else LEAF_REL


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_serving_equals_the_references_sharded_steps(runs, arch):
    name = f"serve-{arch}"
    ref = runs["ref"][name]
    _check_serving(result(runs["port"], name), ref["mesh"], _bar(ref),
                   f"{arch} against the reference's 2x2 steps")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_equals_the_ports_unsharded_steps(runs, arch):
    name = f"serve-{arch}"
    got, plain = result(runs["port"], name), runs["plain"][name]
    _check_serving(got, plain, _bar(runs["ref"][name]),
                   f"{arch} against the port without a mesh")
    assert max_rel(got["step_last"], plain["step_last"]) <= LEAF_REL
    for i in (1, 2):
        np.testing.assert_array_equal(
            got[f"next{i}"], np.argmax(got[f"dec{i}"], axis=-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_keep_the_rule_tables_placements(runs, arch):
    assert result(runs["port"], f"serve-{arch}")["faults"] == []


def test_device_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        device_mesh(card_mesh(), "cpu")
