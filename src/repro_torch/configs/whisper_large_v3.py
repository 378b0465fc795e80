"""whisper-large-v3: 32L d_model=1280 20H d_ff=5120 vocab=51866 — encoder-
decoder; the conv/mel frontend is a STUB: input_specs provides precomputed
frame embeddings (B, 1500, d_model) [arXiv:2212.04356; unverified].
long_500k is skipped (full attention, enc-dec)."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
    activation="gelu", rope_fraction=0.0, enc_dec=True, enc_layers=32,
    enc_frames=1500)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=128,
                               enc_layers=2, enc_frames=16,
                               dec_positions=256)
