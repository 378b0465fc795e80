"""Model configuration for the assigned architecture pool.

One dataclass covers all ten families (dense / MoE / SSM / hybrid / VLM /
audio enc-dec); family-specific fields are ignored where inapplicable.
All dtypes are explicit (bf16 params / f32 master) — SQL-side x64 does not
leak in here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 → d_model // n_heads
    activation: str = "swiglu"      # swiglu | squared_relu | gelu
    rope_fraction: float = 1.0      # chatglm-style 2d rope uses 0.5
    rope_theta: float = 10000.0
    qk_norm: bool = False           # chameleon-style query/key norm
    max_seq_len: int = 1 << 20
    # attention window; 0 → full attention (quadratic)
    sliding_window: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid: parallel attention + SSM heads in every block (Hymba)
    hybrid_parallel: bool = False
    # encoder-decoder (Whisper): encoder frames are stubbed embeddings
    enc_dec: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500
    # learned decoder position table length (whisper-large-v3 is 448 in the
    # real model; sized to the assigned decode/prefill shapes here)
    dec_positions: int = 32768
    # norm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # -- beyond-paper performance knobs (EXPERIMENTS.md §Perf) --
    # pad embedding/vocab rows to a multiple (0/1 = off): keeps the vocab
    # dim divisible by the TP degree so logits shard without padding
    # pathologies (Megatron-style vocab padding)
    vocab_pad: int = 1
    # Megatron sequence parallelism: shard the residual stream's sequence
    # dim over the model axis between blocks (reduce-scatter/all-gather
    # instead of all-reduce; remat stash divided by the TP degree)
    seq_parallel: bool = False

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad and self.vocab_pad > 1:
            return -(-self.vocab // self.vocab_pad) * self.vocab_pad
        return self.vocab

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family == "ssm" or self.sliding_window > 0

    def param_count(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6·N·D."""
        d, hd = self.d_model, self.head_dim_
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family != "ssm":
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.family in ("ssm", "hybrid"):
            di, ns = self.d_inner, self.ssm_state
            # in_proj (x, z, B, C, dt), out_proj
            per_layer += d * (2 * di + 2 * ns + self.n_ssm_heads) + di * d
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * self.d_ff \
                + d * self.n_experts
        elif self.d_ff:
            mult = 3 if self.activation == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        total = emb + self.n_layers * per_layer
        if self.enc_dec:
            enc_layer = (4 * d * d + (3 if self.activation == "swiglu"
                                      else 2) * d * self.d_ff)
            # decoder cross-attention
            total += self.enc_layers * enc_layer + \
                self.n_layers * 4 * d * d
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE uses top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_like = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * self.d_ff)
        return dense_like + self.n_layers * self.top_k * 3 * d * self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                       # train_4k | prefill_32k | ...
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
