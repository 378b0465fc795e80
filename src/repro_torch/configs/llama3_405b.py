"""llama3-405b: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256 —
GQA, 128k vocab [arXiv:2407.21783; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
    activation="swiglu", rope_theta=500000.0)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=128, n_heads=8,
                               n_kv_heads=2, d_ff=384, vocab=256)
