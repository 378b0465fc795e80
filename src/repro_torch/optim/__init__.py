from repro_torch.optim.adamw import AdamW, cosine_schedule

__all__ = ["AdamW", "cosine_schedule"]
