"""chatglm3-6b: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 —
2d RoPE (half-dim rotary), GQA [arXiv:2406.12793; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024,
    activation="swiglu", rope_fraction=0.5)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=160, vocab=128)
