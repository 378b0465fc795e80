"""A sharded training state through the port's checkpoint store
(``checkpoint/store.py``): four gloo ranks on a 2×2 (data, model) CPU
mesh (``tests/_mesh_ranks.py``, the ``checkpoint`` and ``placements``
tasks) against the reference's store and steps jitted over
``make_debug_mesh(2, 2)`` (``tests/_mesh_reference.py``), at
granite-3-2b, granite-moe-1b-a400m (expert leaves) and mamba2-130m
reduced, from the reference's parameters.

(a) Every rank's save of the DTensor state writes the same objects, byte
for byte, as the save of the gathered state; the laid-out parameters
save as the plain ones, and so does a tree of every placement the rule
tables make (the ``("data", "model")`` column nesting included).
(b) Restore, ``shard_tree`` with the run's specs and step 2 equal an
uninterrupted step 2 bit for bit, in the rule tables' placements.
(c) The reference restores the port's objects bit for bit; the port
resumes from the reference's save of its own sharded state, and its
step 2 is held to the reference's step 2 from the same bytes by the
bars of ``tests/test_torch_mesh_train.py``. (d) In process, on one gloo
rank: the save gathers one leaf at a time.
"""

import socket
import weakref

import jax
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import _mesh_ranks as ranks
from _mesh_parity import (ILL, LEAF_REL, LOSS_REL, WORLD, MeshRun,
                          leaf_errors, reference_params, rel, result,
                          train_batch)
from repro.checkpoint import store as jstore
from repro.storage import ObjectStore as JStore
from repro_torch import tree
from repro_torch.launch.mesh import card_mesh, device_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import sharding as tsh
from repro_torch.storage import msgpack_codec

ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-130m"]
LR2 = 6e-4            # the trainer's rate at step 2 (3e-3 · 2/10 warm-up)
# a leaf for each placement the rule tables make, with its spec's
# entries (``sharding.P(*entries)``)
PLACED = {
    "replicated": ((6, 5), np.float32, ()),
    "rows": ((8, 6), np.float32, ("data", None)),
    "cols": ((6, 8), np.float32, (None, "model")),
    "both": ((8, 12), np.float32, ("data", "model")),
    "nested": ((4, 16), np.float32, (None, ("data", "model"))),
    "experts": ((4, 6, 8), np.float32, ("model", None, "data")),
    "ids": ((8,), np.int32, ("data",)),
    "step": ((), np.int32, ()),
}


def _placed_tree() -> dict:
    rng = np.random.default_rng(3)
    return {k: np.asarray(rng.normal(size=shape) * 10).astype(dtype)
            for k, (shape, dtype, _) in PLACED.items()}


def _cases(tmp) -> list[dict]:
    cases = [dict(name=f"ckpt-{arch}", arch=arch, task="checkpoint",
                  params=reference_params(arch), batch=train_batch(arch, 0),
                  batch2=train_batch(arch, 1), ref=True,
                  ref_ckpt=str(tmp / f"ref-{arch}.pkl")) for arch in ARCHS]
    cases.append(dict(name="placements", arch="granite-3-2b",
                      task="placements", tree=_placed_tree(),
                      spec_entries={k: v[2] for k, v in PLACED.items()}))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    port, ref = MeshRun(_cases(tmp), tmp).wait()
    return {"port": port, "ref": ref}


def _state_equal(got: dict, want: dict) -> None:
    g, w = tree.flatten_with_names(got), tree.flatten_with_names(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_save_is_the_gathered_save(runs, arch):
    """(a) On every rank: the laid-out parameters save as the plain ones,
    and the stepped DTensor state as its gathered tree; the manifest
    records each leaf's global shape."""
    got = result(runs["port"], f"ckpt-{arch}")
    assert len(got["ranks"]) == WORLD
    for r, diff in enumerate(got["ranks"]):
        assert diff == {"laid_vs_plain": [], "sharded_vs_gathered": []}, r
    manifest = msgpack_codec.unpackb(
        got["objects"]["ckpt/run/step00000001/MANIFEST"])
    whole = dict(tree.flatten_with_names(got["step1"]))
    assert [leaf["name"] for leaf in manifest["leaves"]] == list(whole)
    for leaf in manifest["leaves"]:
        assert tuple(leaf["shape"]) == whole[leaf["name"]].shape
        assert leaf["dtype"] == whole[leaf["name"]].dtype.name


def test_every_placement_saves_as_its_plain_tree(runs):
    """(a) A tree of every placement, laid out by ``shard_tree``: each
    rank's save equals the plain tree's save byte for byte, and device
    (d, m) holds chunk d·M + m of the column-nested leaf."""
    got = result(runs["port"], "placements")
    plain = _placed_tree()
    assert got["placements"]["nested"] == ("Shard(dim=1)", "Shard(dim=1)")
    assert got["placements"]["experts"] == ("Shard(dim=2)", "Shard(dim=0)")
    chunks = np.split(plain["nested"], WORLD, axis=1)
    seen = set()
    for r in got["ranks"]:
        assert r["differing"] == []
        d, m = r["coordinate"]
        np.testing.assert_array_equal(r["local"]["nested"],
                                      chunks[d * 2 + m])
        seen.add((d, m))
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}
    js = JStore(tier="local")
    jstore.save_checkpoint(js, "run", 0, plain)
    assert {k: js.get(k).data for k in js.list("")} == got["objects"]


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_equals_the_uninterrupted_step(runs, arch):
    """(b) Step 2 from the restored, re-laid-out state against step 2 of
    the run that never stopped: loss, grad_norm and every parameter and
    optimizer leaf bit for bit, every leaf in its rule-table placements."""
    got = result(runs["port"], f"ckpt-{arch}")
    resumed, whole = got["resumed"], got["uninterrupted"]
    assert resumed["faults"] == [] and whole["faults"] == []
    assert resumed["loss"] == whole["loss"]
    assert resumed["grad_norm"] == whole["grad_norm"]
    _state_equal(resumed["state"], whole["state"])
    assert int(resumed["state"]["opt"]["step"]) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_the_reference_restores_the_ports_sharded_save(runs, arch):
    """(c) The port's step-1 objects (every rank's, rank 0's here)
    restored by the reference's store: names, dtypes, shapes and values
    of the port's gathered state, bit for bit."""
    got = result(runs["port"], f"ckpt-{arch}")
    js = JStore(tier="local")
    for k, v in got["objects"].items():
        js.put(k, v)
    back, step = jstore.load_checkpoint(js, "run", got["step1"])
    assert step == 1
    names = [n for n, _ in jstore._flatten_with_names(back)]
    assert names == [n for n, _ in tree.flatten_with_names(got["step1"])]
    _state_equal(jax.tree.map(np.asarray, back), got["step1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_the_port_resumes_the_references_sharded_save(runs, arch):
    """(c) The reference's save of its own sharded step-1 state, restored
    by the port onto its 2×2 mesh: step 2 from those bytes against the
    reference's step 2 from the same bytes, loss and grad_norm within
    1e-5, each leaf within 1e-4 of its largest; an element whose AdamW
    denominator ``sqrt(v̂)`` is under ``ILL · eps`` (and not zero) is
    held to ``2 · lr`` instead, since there the gradients' last bits
    move the update by up to that."""
    name = f"ckpt-{arch}"
    got = result(runs["port"], name)["from_reference"]
    want = runs["ref"][name]["mesh"]
    assert got["faults"] == []
    assert int(got["state"]["opt"]["step"]) == 2
    assert rel(got["loss"], want["loss"]) <= LOSS_REL, \
        (got["loss"], want["loss"])
    assert rel(got["grad_norm"], want["grad_norm"]) <= LOSS_REL, \
        (got["grad_norm"], want["grad_norm"])
    opt = ranks.trainer_optimizer()
    bc2 = 1 - opt.b2 ** 2
    ill = [(np.sqrt(v / bc2) < ILL * opt.eps) & (v != 0)
           for v in tree.leaves(got["state"]["opt"]["v"])]
    well, rest = leaf_errors(got["state"]["params"], want["params"], ill)
    names = [n for n, _ in tree.flatten_with_names(want["params"])]
    print(f"{arch}: step 2 from the reference's bytes, leaves within "
          f"{max(well):.3g} of max, {sum(int(m.sum()) for m in ill)} "
          f"ill-conditioned elements within {max(rest):.3g}")
    bad = {n: e for n, e in zip(names, well) if e > LEAF_REL}
    assert not bad, bad
    assert max(rest) <= 2 * LR2


# -- (d) in process: one leaf at a time ---------------------------------------

@pytest.fixture
def one_rank_mesh():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield device_mesh(card_mesh(), "cpu")
    finally:
        dist.destroy_process_group()


def test_save_gathers_one_leaf_at_a_time(one_rank_mesh, monkeypatch):
    """``DTensor.full_tensor`` wrapped to return a fresh buffer (as a
    gather over more than one rank does) and keep a weak reference to
    it: when each gather starts, no earlier gathered leaf is alive, and
    each leaf is gathered once. The same probe around ``gather_tree``
    sees every earlier leaf alive."""
    plan = tsh.make_plan(one_rank_mesh)
    params = params_from_numpy(reference_params("granite-3-2b"))
    dp = tsh.shard_tree(plan, params, tsh.param_shardings(plan, params))
    state = {"params": dp, "opt": ranks.trainer_optimizer().init(dp)}
    n = len(tree.leaves(state))
    alive, gathered = [], []
    real = DTensor.full_tensor

    def full_tensor(self, *args, **kwargs):
        alive.append(sum(r() is not None for r in gathered))
        out = real(self, *args, **kwargs).clone()
        gathered.append(weakref.ref(out))
        return out
    monkeypatch.setattr(DTensor, "full_tensor", full_tensor)
    objects = ranks.saved(1, state)
    assert len(gathered) == n and alive == [0] * n
    alive.clear()
    gathered.clear()
    whole = tsh.gather_tree(state)
    assert alive == list(range(n))
    assert ranks.saved(1, whole) == objects
