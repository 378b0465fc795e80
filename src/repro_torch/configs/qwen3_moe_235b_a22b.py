"""qwen3-moe-235b-a22b: 94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per
expert) vocab=151936, MoE 128 experts top-8, head_dim=128, qk-norm
[hf:Qwen/Qwen3-30B-A3B; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
    activation="swiglu", qk_norm=True, n_experts=128, top_k=8)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab=128, n_experts=8, top_k=2, capacity_factor=8.0)
