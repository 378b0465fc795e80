"""The port's model stack against the reference's, for the
architectures with a Mamba2 mixer or experts (SSM, the hybrid with a
sliding window, the two MoEs), each at its reduced config on the CPU in
float32, as ``tests/test_torch_models.py`` holds the others (through
``tests/_model_parity.py``). Hymba's reduced window of 32 reaches each
branch of the ring store ``decode._ring``: the scatter at S 48, the
identity tail at S 64 and the pad at S 16.
"""

import pytest

from _model_parity import (build_case, case_id, check_consistency,
                           check_forward, check_serving)

CASES = [("mamba2-130m", 48), ("hymba-1.5b", 48), ("hymba-1.5b", 64),
         ("hymba-1.5b", 16), ("qwen3-moe-235b-a22b", 48),
         ("granite-moe-1b-a400m", 48)]


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
