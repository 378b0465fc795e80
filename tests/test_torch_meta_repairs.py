"""Two repairs that let every model cell trace on ``meta`` and drop a
device→host read from the card's step, each held bit for bit against
the code it replaced, on the CPU:

* ``models/moe.route`` counts each expert's tokens with a scatter-add
  instead of ``torch.bincount`` (no meta kernel; on the card it reads its
  maximum back to the host): the counts, ranks, slots and keep mask
  equal ``bincount``'s, experts that no token chose included;
* ``models/decode.decode_step`` takes the decoder position row with
  ``index_select`` instead of indexing with the 0-d ``pos`` (which calls
  ``.item()``): the logits and the cache equal the old path's.

Both cells then trace on ``meta``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.models import decode as decode_lib
from repro_torch.models import moe as tmoe
from repro_torch.models.model import init_params
from repro_torch.tree import flatten_with_names


def _bincount_slots(flat_e, E, capacity):
    """The ranking of ``route`` as it was: ``torch.bincount`` counts."""
    Tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(Tk) - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < capacity
    return counts, torch.where(keep, rank, 0), keep


@pytest.mark.parametrize("E", [8, 64, 128])
def test_route_counts_equal_bincount(E):
    rng = np.random.default_rng(E)
    T, D, k = 48, 16, 2
    x = torch.from_numpy(np.abs(rng.normal(size=(T, D))).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(D, E)).astype(np.float32))
    router[:, 0] = -10.0                # x > 0: no token picks expert 0
    C = tmoe.moe_capacity(T, E, k, 1.0)
    _, _, top_i, flat_e, slot, keep = tmoe.route(x, router, k=k, capacity=C)
    counts, want_slot, want_keep = _bincount_slots(flat_e, E, C)
    assert counts[0] == 0 and (counts == 0).sum() >= 1
    assert torch.equal(slot, want_slot)
    assert torch.equal(keep, want_keep)
    assert torch.equal(flat_e, top_i.reshape(-1))


def _old_position_row(monkeypatch):
    """``decode_step``'s position row as it was: the 0-d ``pos`` as an
    index (a one-element ``index_select`` on dim 0 is the only call)."""
    orig = torch.Tensor.index_select
    calls = []

    def index_select(self, dim, index):
        if dim == 0 and index.numel() == 1:
            calls.append(1)
            return self[index.reshape(())][None]
        return orig(self, dim, index)

    monkeypatch.setattr(torch.Tensor, "index_select", index_select)
    return calls


def _decode_run(cfg, params, steps=3):
    cache = decode_lib.init_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
    cache["cross_k"].normal_(generator=torch.Generator().manual_seed(1))
    cache["cross_v"].normal_(generator=torch.Generator().manual_seed(2))
    tokens = torch.tensor([3, 7], dtype=torch.int32)
    out = []
    for _ in range(steps):
        logits, cache = decode_lib.decode_step(cfg, params, cache, tokens)
        tokens = torch.argmax(logits, -1).to(torch.int32)
        out.append(logits)
    return out, cache


def test_whisper_decode_equals_the_zero_dim_index(monkeypatch):
    cfg = get_reduced("whisper-large-v3")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    new_logits, new_cache = _decode_run(cfg, params)
    calls = _old_position_row(monkeypatch)
    old_logits, old_cache = _decode_run(cfg, params)
    assert len(calls) == 3
    for a, b in zip(new_logits, old_logits):
        assert torch.equal(a, b)
    for (n, a), (_, b) in zip(flatten_with_names(new_cache),
                              flatten_with_names(old_cache)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-1b-a400m", "train_4k"),
    ("qwen3-moe-235b-a22b", "prefill_32k"),
    ("whisper-large-v3", "decode_32k")])
def test_reduced_cells_trace_on_meta(arch, shape):
    cell = tspecs.build_cell(get_reduced(arch), arch, shape)
    trace = dryrun.trace_cell(cell)
    assert trace.flops > 0 and trace.step_peak_bytes > 0


def test_full_width_moe_and_whisper_decode_trace_on_meta():
    for arch in ("qwen3-moe-235b-a22b", "whisper-large-v3"):
        cell = tspecs.build_cell(get_config(arch), arch, "decode_32k")
        trace = dryrun.trace_cell(cell)
        logits = trace.outputs[1]
        assert logits.device.type == "meta"
        assert tuple(logits.shape) == (128, get_config(arch).padded_vocab)
