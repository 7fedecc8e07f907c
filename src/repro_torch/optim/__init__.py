"""Optimizers (functional, over parameter trees)."""
from repro_torch.optim.opt import adamw, sgd

__all__ = ["sgd", "adamw"]
