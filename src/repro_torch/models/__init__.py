"""The model stack of the port: configs and building blocks (``config``,
``layers``, ``ssm``, ``moe``), the assembled LM (``model``), the serving
path (``decode``: cache, prefill, decode step; ``steps``: the prefill
and serve steps) and ``convert`` (the reference's parameters as
tensors)."""

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ModelConfig", "SHAPES", "ShapeConfig"]
