"""granite-3-2b: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155 — GQA
[hf:ibm-granite/granite-3.0-2b-base; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155,
    activation="swiglu", tie_embeddings=True)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=128)
