"""Analytic HBM-traffic and residency model per (arch × shape × mesh) cell
— the port of ``repro.analysis.memtraffic``: the same model, a host copy
on the port's ``models.config``. One difference: ``fits_hbm`` compares
the residency against the H100's 80 GB (``analysis/roofline.H100_SXM``)
by default, where the reference's compares against the TPU v5e's 16 GiB;
``MemoryModel.hbm_bytes`` (an argument of ``analyze_memory``) sets
another card's capacity.

The reference's reasons for an analytic model, as it gives them. Why
analytic: the dry-run compiles against the CPU backend, whose scheduler
neither fuses like TPU XLA nor runs memory-pressure passes (no 16 GiB
limit), so neither `cost_analysis()['bytes accessed']` (unfused: ~40×
inflated) nor `memory_analysis().temp_size` (no rematerialization
scheduling) transfers to TPU. FLOPs and the GSPMD collective schedule *do*
transfer — those stay artifact-derived. The memory roofline term instead
uses this model, parameterized only by the cell config and mesh, assuming
TPU-standard fusion (flash attention keeps S×S tiles in VMEM; elementwise
chains fuse into one HBM pass).

All quantities are per device, per step.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.roofline import H100_SXM
from repro_torch.models.config import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


@dataclasses.dataclass
class MemoryModel:
    traffic_bytes: float          # HBM bytes moved per step
    residency_bytes: float        # steady-state HBM footprint
    detail: dict
    hbm_bytes: float = H100_SXM["hbm_bytes"]   # the card's capacity

    @property
    def fits_hbm(self) -> bool:
        return self.residency_bytes < self.hbm_bytes


def _layer_param_count(cfg: ModelConfig) -> int:
    per = (cfg.param_count() - cfg.vocab * cfg.d_model
           * (1 if cfg.tie_embeddings else 2))
    return per // max(cfg.n_layers, 1)


def analyze_memory(cfg: ModelConfig, shape: ShapeConfig, *,
                   n_devices: int, dp: int, tp: int, kind: str,
                   accum_steps: int = 1,
                   opt_bytes_per_param: float = 12.0,
                   hbm_bytes: float = H100_SXM["hbm_bytes"]
                   ) -> MemoryModel:
    P = cfg.param_count()
    L = cfg.n_layers
    D = cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    tok_dp = B * S / dp if kind != "decode" else B / dp
    hd = cfg.head_dim_
    detail: dict = {}

    # -- parameter/optimizer traffic ------------------------------------------
    if kind == "train":
        # read f32 params + m/v, write all three (AdamW), plus one bf16
        # cast read of params in fwd and bwd each (all-gathered FSDP
        # shards are streamed, but each device still sources its 1/dev
        # share once).
        param_traffic = P / n_devices * (
            2 * (F32 + opt_bytes_per_param) + 2 * BF16)
        resid_params = P / n_devices * (F32 + opt_bytes_per_param)
    else:
        param_traffic = P / n_devices * BF16
        resid_params = P / n_devices * BF16
    detail["param_traffic"] = param_traffic

    # -- activation traffic -----------------------------------------------------
    # residual-stream tensors (not TP-sharded): ~6 HBM passes per layer fwd;
    # wide tensors (d_ff / head projections, TP-sharded): ~4 passes.
    wide = max(cfg.d_ff if not cfg.n_experts else cfg.top_k * cfg.d_ff,
               cfg.n_heads * hd)
    if cfg.family in ("ssm", "hybrid"):
        wide = max(wide, cfg.d_inner + 2 * cfg.ssm_state)
    passes = 3.0 if kind == "train" else 1.0   # fwd+bwd+remat-recompute
    act_layer = tok_dp * (6 * D + 4 * wide / tp) * BF16
    act_traffic = act_layer * L * passes
    detail["act_traffic"] = act_traffic

    # -- attention KV traffic (flash kernel: scores stay in VMEM) ---------------
    kv_traffic = 0.0
    if cfg.family != "ssm" and kind != "decode":
        eff_S = min(S, cfg.sliding_window) if cfg.sliding_window else S
        q_chunks = max(S // 1024, 1)
        reread = min(q_chunks, max(eff_S // 1024, 1))
        kv_traffic = (B / dp) * cfg.n_kv_heads * eff_S * hd * BF16 \
            * 2 * reread * L * passes
    if kind == "decode" and cfg.family != "ssm":
        C = min(S, cfg.sliding_window) if cfg.sliding_window else S
        kv_traffic = L * (B / dp) * cfg.n_kv_heads * (C / tp) * hd \
            * BF16 * 2                       # read full cache (k+v)
        kv_traffic += L * (B / dp) * cfg.n_kv_heads * hd * BF16 * 2  # write
    if cfg.enc_dec and kind == "decode":
        kv_traffic += L * (B / dp) * cfg.n_heads * (cfg.enc_frames / tp) \
            * hd * BF16 * 2
    detail["kv_traffic"] = kv_traffic

    # -- SSM state traffic --------------------------------------------------------
    ssm_traffic = 0.0
    if cfg.family in ("ssm", "hybrid"):
        state = cfg.n_ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
        if kind == "decode":
            ssm_traffic = L * (B / dp) * (state / tp) * F32 * 2
        else:
            n_chunks = max(S // cfg.ssm_chunk, 1)
            ssm_traffic = L * (B / dp) * state * F32 * 2 * n_chunks \
                * passes
    detail["ssm_traffic"] = ssm_traffic

    # -- logits + loss ------------------------------------------------------------
    logit_traffic = 0.0
    if kind == "train":
        logit_traffic = tok_dp * (cfg.vocab / tp) * BF16 * 3
    elif kind == "prefill":
        logit_traffic = (B / dp) * (cfg.vocab / tp) * BF16
    else:
        logit_traffic = (B / dp) * (cfg.vocab / tp) * BF16
    detail["logit_traffic"] = logit_traffic

    traffic = (param_traffic + act_traffic + kv_traffic + ssm_traffic
               + logit_traffic)

    # -- residency ------------------------------------------------------------------
    resid = resid_params
    if kind == "train":
        # remat stash: one residual-stream activation per layer (sharded
        # over TP under sequence parallelism, divided by microbatching)
        stash = L * tok_dp * D * BF16 / accum_steps
        if cfg.seq_parallel:
            stash /= tp
        resid += stash
        resid += tok_dp * (cfg.padded_vocab / tp) * BF16 / accum_steps
        if accum_steps > 1:
            resid += P / n_devices * F32   # gradient accumulation buffer
    if kind != "train" and cfg.family != "ssm":
        C = min(S, cfg.sliding_window) if cfg.sliding_window else S
        resid += L * (B / dp) * cfg.n_kv_heads * (C / tp) * hd * BF16 * 2
    if cfg.family in ("ssm", "hybrid") and kind != "train":
        state = cfg.n_ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
        resid += L * (B / dp) * (state / tp) * F32
    if cfg.enc_dec and kind != "train":
        resid += L * (B / dp) * cfg.n_heads * cfg.enc_frames * hd * BF16 \
            * 2 / tp
    detail["residency"] = resid

    return MemoryModel(traffic, resid, detail, hbm_bytes)
