"""Input specs per (arch × shape) cell — the port of
``repro.launch.specs``: the shapes and dtypes of each cell's arguments,
and the step callable that runs on them.

The reference's stand-ins are ``jax.ShapeDtypeStruct`` trees from
``jax.eval_shape``; here they are tensors on the ``meta`` device, which
carry a shape and a dtype and no storage: ``init_params`` walks the
parameter shapes with no generator (``models/model.py``), and the cache
and the optimizer state are made on ``meta`` directly. Nothing is
allocated, so a cell at llama3-405b's full width costs nothing to build.

``build_cell(..., mesh=)`` passes ``mesh`` to the step: None (the dry
run lays the rule tables over an ``AxisMesh`` itself) or a
``DeviceMesh``, whose step then takes DTensor arguments laid out by the
rule tables (``parallel/sharding.shard_tree``), not these stand-ins.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import decode as decode_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.model import init_params
from repro_torch.optim import AdamW

META = torch.device("meta")


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: ShapeConfig
    kind: str                   # train | prefill | decode
    step_fn: object             # the step callable
    arg_specs: tuple            # trees of meta tensors
    donate_argnums: tuple = ()
    skip_reason: str | None = None


def spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on ``meta``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def params_specs(cfg: ModelConfig, dtype=torch.float32):
    return init_params(cfg, None, dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": spec((B, S), torch.int32),
        "labels": spec((B, S), torch.int32),
    }
    if cfg.enc_dec:
        out["frames"] = spec((B, cfg.enc_frames, cfg.d_model),
                             torch.bfloat16)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return decode_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 torch.bfloat16, device=META)


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention at 524k sequence — skipped per "
                "assignment; runs for SSM/hybrid archs only")
    return None


def build_cell(cfg: ModelConfig, arch: str, shape_name: str, *,
               mesh=None, optimizer: AdamW | None = None,
               remat: bool = True, scan_layers: bool = True,
               accum_steps: int = 1) -> CellSpec:
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return CellSpec(arch, shape, shape.kind, None, (), (), reason)

    if shape.kind == "train":
        opt = optimizer or AdamW()
        p_specs = params_specs(cfg, torch.float32)
        o_specs = opt.init(p_specs)
        b_specs = batch_specs(cfg, shape)
        step = steps_lib.make_train_step(cfg, opt, mesh=mesh, remat=remat,
                                         scan_layers=scan_layers,
                                         accum_steps=accum_steps)
        return CellSpec(arch, shape, "train", step,
                        (p_specs, o_specs, b_specs), donate_argnums=(0, 1))
    if shape.kind == "prefill":
        p_specs = params_specs(cfg, torch.bfloat16)
        b_specs = batch_specs(cfg, shape)
        b_specs.pop("labels")
        step = steps_lib.make_prefill_step(cfg, mesh=mesh,
                                           scan_layers=scan_layers)
        return CellSpec(arch, shape, "prefill", step, (p_specs, b_specs))
    # decode
    p_specs = params_specs(cfg, torch.bfloat16)
    c_specs = cache_specs(cfg, shape)
    t_spec = spec((shape.global_batch,), torch.int32)
    step = steps_lib.make_serve_step(cfg, mesh=mesh,
                                     scan_layers=scan_layers)
    return CellSpec(arch, shape, "decode", step,
                    (p_specs, c_specs, t_spec), donate_argnums=(1,))
