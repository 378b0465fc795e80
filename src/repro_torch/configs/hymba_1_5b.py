"""hymba-1.5b: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads in every block
[arXiv:2411.13676; hf]. Sliding-window attention (global-attention layers
of the paper are approximated as windowed; see DESIGN.md) makes the arch
sub-quadratic, so the long_500k cell runs."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
    activation="swiglu", hybrid_parallel=True, sliding_window=1024,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, sliding_window=32,
        ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
