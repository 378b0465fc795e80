"""mamba2-130m: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, vocab=128,
                               ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
