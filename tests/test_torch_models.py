"""The port's model stack against the reference's, for the attention
architectures without a mixer or experts (dense, GQA, the VLM with query
and key norms, the enc-dec), each at its reduced config on the CPU in
float32: forward logits, prefill logits and cache, two decode steps
(1e-4 of the largest reference value), and prefill / decode against the
port's own full forward (2e-3), through ``tests/_model_parity.py``.
Also ``decode._ring``'s three branches on a known tensor.
"""

import pytest
import torch

from _model_parity import (build_case, case_id, check_consistency,
                           check_forward, check_serving)
from repro_torch.models import decode as tdecode

CASES = [(a, 48) for a in ("granite-3-2b", "chatglm3-6b", "llama3-405b",
                           "nemotron-4-15b", "chameleon-34b",
                           "whisper-large-v3")]


@pytest.fixture(scope="module", params=CASES,
                ids=[case_id(c) for c in CASES])
def case(request):
    return build_case(*request.param)


def test_forward_logits_match_reference(case):
    check_forward(case)


def test_prefill_and_two_decode_steps_match_reference(case):
    check_serving(case)


def test_prefill_decode_consistent_with_own_forward(case):
    check_consistency(case)


def test_ring_branches():
    """``_ring`` at each of its three branches: slot ``pos % W`` holds
    position ``pos`` for the last W positions, and zeros past S."""
    k = torch.arange(480, dtype=torch.float32).reshape(2, 3, 20, 4)
    for S, W in ((20, 32), (20, 10), (20, 6), (20, 20)):
        ring = tdecode._ring(k[:, :, :S], W)
        assert ring.shape[2] == W
        for pos in range(max(S - W, 0), S):
            assert torch.equal(ring[:, :, pos % W], k[:, :, pos]), (S, W)
        for slot in range(S, W):
            assert not ring[:, :, slot].any(), (S, W)
