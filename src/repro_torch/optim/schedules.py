"""LR schedules — the Fig. 4 set: constant, linear, cosine, step, inv-sqrt.

The port's copy of ``repro.optim.schedules``.  Each returns the factor of
the master LR at a step, computed in numpy float32 as the reference's
``jnp`` arithmetic computes it, so the schedule *shape* is a muTransferable
HP (Table 2) and total steps a transferred-across one (Table 1).  The port
steps from the host, so a schedule is a plain function of the int step.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

F32 = np.float32


def constant() -> Callable:
    return lambda step: F32(1.0)


def warmup_factor(step, warmup_steps):
    """Linear warmup multiplier (non-positive warmup means no warmup)."""
    ws = F32(warmup_steps)
    if ws <= 0:
        return F32(1.0)
    return np.minimum(F32(1.0), F32(step + 1) / np.maximum(ws, F32(1.0)))


def _progress(step, total_steps, warmup_steps):
    ts, ws = F32(total_steps), F32(warmup_steps)
    return np.clip((F32(step) - ws) / np.maximum(ts - ws, F32(1.0)),
                   F32(0.0), F32(1.0))


def linear_decay(total_steps, warmup_steps=0, end_factor: float = 0.0) -> Callable:
    def f(step):
        t = _progress(step, total_steps, warmup_steps)
        return F32(warmup_factor(step, warmup_steps)
                   * ((F32(1) - t) + t * F32(end_factor)))

    return f


def cosine(total_steps, warmup_steps=0, end_factor: float = 0.0) -> Callable:
    def f(step):
        t = _progress(step, total_steps, warmup_steps)
        c = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * t))
        return F32(warmup_factor(step, warmup_steps)
                   * (F32(end_factor) + (F32(1) - F32(end_factor)) * c))

    return f


def step_decay(milestones: Sequence[int], gamma: float = 0.1) -> Callable:
    ms = tuple(milestones)

    def f(step):
        return F32(gamma) ** F32(sum(step >= m for m in ms))

    return f


def inv_sqrt(warmup_steps=1000) -> Callable:
    def f(step):
        s = np.maximum(F32(step), F32(1.0))
        w = np.maximum(F32(warmup_steps), F32(1.0))
        return np.minimum(s / w, np.sqrt(w / s))

    return f


SCHEDULES = {
    "constant": constant,
    "linear": linear_decay,
    "cosine": cosine,
    "step": step_decay,
    "inv_sqrt": inv_sqrt,
}


def make_schedule(name: str, **kw) -> Callable:
    return SCHEDULES[name](**kw)
