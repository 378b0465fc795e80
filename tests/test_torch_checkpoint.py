"""The port's checkpoint store (``checkpoint/store.py``) against the
reference's, on the CPU.

For the same tree and codec both packages must write the same objects,
byte for byte: leaf objects, manifest and ``latest`` pointer, with zstd
and with zlib (``DEFAULT_CODEC`` set in both packages' ``compression``
modules), float32 and bf16 optimizer state. A checkpoint written by
either restores in the other, through stores that copy the objects
across. Each leaf's decompression is capped at the size its manifest
declares (the reference caps every leaf at ``1 << 31`` bytes, which a
full-width granite-3-2b leaf passes), and a leaf whose bytes exceed or
fall short of it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.models import model as jmodel
from repro.optim import AdamW as JAdamW
from repro.storage import ObjectStore as JStore
from repro.storage import compression as jcompression
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import store as tstore
from repro_torch.launch.specs import params_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW
from repro_torch.storage import ObjectStore as TStore
from repro_torch.storage import compression as tcompression
from repro_torch.storage import msgpack_codec

ARCH = "granite-3-2b"
CODECS = [c for c in ("zstd", "zlib")
          if c == "zlib" or (jcompression.HAVE_ZSTD
                             and tcompression.HAVE_ZSTD)]
STATE = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(params=CODECS)
def codec(request, monkeypatch):
    monkeypatch.setattr(jcompression, "DEFAULT_CODEC", request.param)
    monkeypatch.setattr(tcompression, "DEFAULT_CODEC", request.param)
    return request.param


def _trees(state: str):
    """The same {params, opt} tree in both packages: the reference's
    parameters and a stepped-looking optimizer state, converted."""
    cfg = jconfigs.get_reduced(ARCH)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(1))
    opt = JAdamW(state_dtype=STATE[state][0]).init(params)
    rng = np.random.default_rng(5)
    opt = {"m": jax.tree.map(lambda x: (x + rng.normal(size=x.shape))
                             .astype(x.dtype), opt["m"]),
           "v": jax.tree.map(lambda x: (x + rng.random(x.shape))
                             .astype(x.dtype), opt["v"]),
           "step": jnp.asarray(7, jnp.int32)}
    jtree = {"params": params, "opt": opt}
    return jtree, params_from_numpy(jax.tree.map(np.asarray, jtree))


def _template(state: str):
    p = params_specs(tconfigs.get_reduced(ARCH))
    return {"params": p, "opt": AdamW(state_dtype=STATE[state][1]).init(p)}


def _copy(src, dst):
    for key in src.list(""):
        dst.put(key, src.get(key).data)


def _equal(got, want):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("state", sorted(STATE))
def test_objects_are_byte_identical(codec, state):
    jtree, ttree = _trees(state)
    js, ts = JStore(tier="local"), TStore(tier="local")
    assert jstore.save_checkpoint(js, "run", 12, jtree) == \
        tstore.save_checkpoint(ts, "run", 12, ttree)
    keys = sorted(js.list(""))
    assert keys == sorted(ts.list(""))
    assert f"ckpt/run/step00000012/opt.m.blocks.w1.{codec}" in keys
    for key in keys:
        assert js.get(key).data == ts.get(key).data, key
    manifest = msgpack_codec.unpackb(
        ts.get("ckpt/run/step00000012/MANIFEST").data)
    names = [leaf["name"] for leaf in manifest["leaves"]]
    assert names == [n for n, _ in tree.flatten_with_names(ttree)]
    assert names[0].startswith("opt/m/") and "opt/step" in names
    assert names.index("opt/step") < names.index("opt/v/embed") \
        < names.index("params/blocks/attn_norm")
    step = manifest["leaves"][names.index("opt/step")]
    assert step["dtype"] == "int32" and step["shape"] == []
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == \
        {"int32", "float32"} | ({state} if state == "bfloat16" else set())


@pytest.mark.parametrize("state", sorted(STATE))
def test_each_package_restores_the_others_checkpoint(codec, state):
    jtree, ttree = _trees(state)
    # port → reference
    ts, js = TStore(tier="local"), JStore(tier="local")
    tstore.save_checkpoint(ts, "run", 3, ttree)
    _copy(ts, js)
    back, step = jstore.load_checkpoint(js, "run", jtree)
    assert step == 3
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    # reference → port, into a template of meta tensors
    js2, ts2 = JStore(tier="local"), TStore(tier="local")
    jstore.save_checkpoint(js2, "run", 4, jtree)
    _copy(js2, ts2)
    assert tstore.latest_step(ts2, "run") == 4
    back, step = tstore.load_checkpoint(ts2, "run", _template(state))
    assert step == 4
    # the template's dict order (init_params's), not the sorted one
    assert list(back["params"]) == ["embed", "blocks", "final_norm"]
    for got, want in zip(tree.leaves(back), jax.tree.leaves(jtree)):
        assert got.device.type == "cpu"
        _equal(got, want)


def test_bf16_state_round_trip(codec):
    _, ttree = _trees("bfloat16")
    ts = TStore(tier="local")
    tstore.save_checkpoint(ts, "run", 1, ttree)
    back, _ = tstore.load_checkpoint(ts, "run", _template("bfloat16"))
    for got, want in zip(tree.leaves(back), tree.leaves(ttree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype ==
                           torch.bfloat16 else want)


def test_cap_is_the_declared_size(codec, monkeypatch):
    _, ttree = _trees("float32")
    ts = TStore(tier="local")
    tstore.save_checkpoint(ts, "run", 1, ttree)
    caps = []
    real = tcompression.decompress

    def recording(data, c, *, max_output_size):
        caps.append(max_output_size)
        return real(data, c, max_output_size=max_output_size)
    monkeypatch.setattr(tcompression, "decompress", recording)
    tstore.load_checkpoint(ts, "run", _template("float32"))
    want = [int(np.prod(t.shape)) * t.element_size()
            for t in tree.leaves(ttree)]
    assert caps == want
    assert 4 in caps                                    # the 0-d step
    assert tstore.declared_bytes(
        {"dtype": "float32", "shape": [40, 2048, 8192]}) == 2_684_354_560
    assert tstore.declared_bytes(
        {"dtype": "bfloat16", "shape": [3, 5]}) == 30


@pytest.mark.parametrize("extra", [8, -4])
def test_a_leaf_past_or_short_of_its_declared_size_raises(codec, extra):
    _, ttree = _trees("float32")
    ts = TStore(tier="local")
    tstore.save_checkpoint(ts, "run", 1, ttree)
    key = f"ckpt/run/step00000001/params.final_norm.{codec}"
    raw = ttree["params"]["final_norm"].numpy().tobytes()
    raw = raw + b"\0" * extra if extra > 0 else raw[:extra]
    ts.put(key, tcompression.compress(raw, codec, level=1))
    with pytest.raises(ValueError, match="declare"):
        tstore.load_checkpoint(ts, "run", _template("float32"))


def test_latest_pointer(codec):
    _, ttree = _trees("float32")
    ts = TStore(tier="local")
    assert tstore.latest_step(ts, "run") is None
    with pytest.raises(FileNotFoundError):
        tstore.load_checkpoint(ts, "run", _template("float32"))
    for step in (2, 5):
        ttree["opt"]["step"] = torch.tensor(step, dtype=torch.int32)
        tstore.save_checkpoint(ts, "run", step, ttree)
    assert tstore.latest_step(ts, "run") == 5
    js = JStore(tier="local")
    _copy(ts, js)
    assert jstore.latest_step(js, "run") == 5
    assert msgpack_codec.unpackb(ts.get("ckpt/run/latest").data) == \
        {"manifest": "ckpt/run/step00000005/MANIFEST", "step": 5}
    for step, want in ((None, 5), (2, 2), (5, 5)):
        back, got = tstore.load_checkpoint(ts, "run", _template("float32"),
                                           step=step)
        assert got == want and int(back["opt"]["step"]) == want
    assert tstore.latest_step(ts, "other") is None
