"""Optimizers, LR schedules and gradient utilities (flat dicts of tensors)."""
