"""Checkpointing to serverless object storage — the port of
``repro.checkpoint.store``, in the reference's format.

Training stages are the ML analog of Skyrise's query stages: each stage's
result (params + optimizer state at step N) is written as immutable,
content-addressed objects, so a restarted (or elastically re-scaled)
training job resumes from the last complete stage exactly like an aborted
query resumes from its last registered pipeline result. Writes are
deterministic per (run, step) → idempotent across racing re-executions.

Layout: ``ckpt/{run}/step{step:08d}/{name}.{codec}``, one compressed
object per leaf, plus a MessagePack ``MANIFEST`` recording the codec and
each leaf's name, key, dtype and shape; a per-run ``latest`` pointer is
the only mutated key. Leaves are named and ordered as the reference's
JAX path flattening names them (``repro_torch.tree``: dict keys sorted,
list items by index; ``opt/m/blocks/w1``, ``opt/step``,
``params/embed``), the manifest goes through
``storage/msgpack_codec.py`` (msgpack's bytes), and a leaf's bytes are
its tensor's, with the reference's dtype names — bf16 as ``bfloat16``,
written through an int16 view since numpy has no bf16 of its own. So
for the same tree and codec both packages write the same objects, and a
checkpoint written by either restores in the other.

One difference: the reference caps every leaf's decompression at
``1 << 31`` bytes, which a full-width granite-3-2b leaf passes (its
stacked ``w1`` and ``w3``, and their AdamW moments, are 2.68 GB each in
float32). Here each leaf is capped at the size its manifest declares,
``prod(shape) × itemsize``, and one whose bytes differ from it raises.

A sharded training state (DTensor leaves laid out over a ``DeviceMesh``
by ``parallel/sharding.py``) saves as the reference saves a sharded JAX
tree, whose ``np.asarray`` gathers each leaf: each DTensor leaf is
gathered whole (``full_tensor``), written, and dropped before the next
leaf is gathered, so a rank holds at most one whole leaf beyond its
shards. The objects are the same bytes as the save of the gathered tree;
there is no per-rank shard format. A restore returns whole tensors; a
sharded run lays them out again with ``sharding.shard_tree`` and the
specs it started with.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.storage import compression
from repro_torch.storage import msgpack_codec as msgpack
from repro_torch.storage.object_store import ObjectStore
from repro_torch.tree import flatten_with_names, unflatten

# torch dtypes by the names the reference's manifests use (numpy's)
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _leaf_bytes(leaf: torch.Tensor) -> tuple[bytes, str, list[int]]:
    """A tensor's bytes (C order, native byte order), dtype name and
    shape, as ``np.asarray(leaf).tobytes()`` gives the reference's; a
    DTensor's are its whole (global) tensor's, gathered here and freed on
    return."""
    t = leaf.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.to("cpu").contiguous()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes(), name, list(t.shape)


def save_checkpoint(store: ObjectStore, run: str, step: int,
                    tree) -> str:
    """Write ``tree`` (tensors, DTensors or both) as step ``step`` of
    ``run``; returns the manifest key.

    A DTensor leaf is gathered, a collective over its mesh: with any
    DTensor in ``tree``, every rank of the mesh calls this with its own
    shards of the same tree, in the same order, and every rank writes the
    same objects (idempotent, as every write here is)."""
    prefix = f"ckpt/{run}/step{step:08d}"
    codec = compression.DEFAULT_CODEC
    manifest = {"step": step, "codec": codec, "leaves": []}
    for name, leaf in flatten_with_names(tree):
        data, dtype, shape = _leaf_bytes(leaf)
        key = f"{prefix}/{name.replace('/', '.')}.{codec}"
        store.put(key, compression.compress(data, codec, level=1))
        del data                     # before the next leaf's gather
        manifest["leaves"].append({
            "name": name, "key": key, "dtype": dtype, "shape": shape})
    mkey = f"{prefix}/MANIFEST"
    store.put(mkey, msgpack.packb(manifest))
    store.put(f"ckpt/{run}/latest", msgpack.packb({"manifest": mkey,
                                                   "step": step}))
    return mkey


def latest_step(store: ObjectStore, run: str) -> int | None:
    key = f"ckpt/{run}/latest"
    if not store.exists(key):
        return None
    return msgpack.unpackb(store.get(key).data)["step"]


def declared_bytes(leaf: dict) -> int:
    """The bytes a manifest entry declares: ``prod(shape) × itemsize``."""
    return math.prod(leaf["shape"]) * _DTYPES[leaf["dtype"]].itemsize


def _restore_leaf(store: ObjectStore, leaf: dict, codec: str,
                  device) -> torch.Tensor:
    size = declared_bytes(leaf)
    raw = compression.decompress(store.get(leaf["key"]).data, codec,
                                 max_output_size=size)
    if len(raw) != size:
        raise ValueError(f"leaf {leaf['name']}: {len(raw)} bytes against "
                         f"the {size} its manifest declares")
    dtype = _DTYPES[leaf["dtype"]]
    view = torch.int16 if dtype == torch.bfloat16 else dtype
    t = torch.frombuffer(bytearray(raw), dtype=view) if size else \
        torch.empty((0,), dtype=view)
    return t.view(dtype).reshape(leaf["shape"]).to(device)


def load_checkpoint(store: ObjectStore, run: str, template,
                    step: int | None = None, *, device=None):
    """Restore a tree matching ``template``'s structure (``template``'s
    leaves give the names and shapes only: ``meta`` tensors will do, and
    so will the DTensors of a sharded state, whose shapes are global).
    The leaves are whole tensors on ``device`` (the CPU by default) with
    the manifest's dtypes; a sharded run lays them out with
    ``sharding.shard_tree``. Returns ``(tree, step)``."""
    if step is None:
        step = latest_step(store, run)
        if step is None:
            raise FileNotFoundError(f"no checkpoint for run {run}")
    mkey = f"ckpt/{run}/step{step:08d}/MANIFEST"
    manifest = msgpack.unpackb(store.get(mkey).data)
    codec = manifest.get("codec", "zstd")
    entries = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    device = torch.device("cpu") if device is None else device
    out = []
    for name, t in flatten_with_names(template):
        leaf = entries[name]
        assert tuple(leaf["shape"]) == tuple(t.shape), \
            (name, leaf["shape"], tuple(t.shape))
        out.append(_restore_leaf(store, leaf, codec, device))
    assert len(out) == len(entries), (len(out), len(entries))
    return unflatten(template, out), step
