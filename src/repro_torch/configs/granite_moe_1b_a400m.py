"""granite-moe-1b-a400m: 24L d_model=1024 16H (GQA kv=8) d_ff=512 (per
expert) vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
    activation="swiglu", n_experts=32, top_k=8, tie_embeddings=True)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128, n_experts=4, top_k=2, capacity_factor=8.0)
