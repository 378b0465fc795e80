from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ModelConfig", "SHAPES", "ShapeConfig"]
