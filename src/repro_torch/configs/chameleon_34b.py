"""chameleon-34b: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 —
early-fusion VLM: VQ image tokens are ordinary vocabulary entries, so the
backbone is a dense decoder with qk-norm; the image tokenizer frontend is a
stub (input_specs provides token ids) [arXiv:2405.09818; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536,
    activation="swiglu", qk_norm=True)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=192, vocab=256)
