"""Rotary position embeddings, in the reference's half-split convention:
the rotated pairs are (x[i], x[i + d/2]), not interleaved (x[2i], x[2i+1]).

The reference's ``apply_rope(x, positions, theta)`` is
``rotate(x, *rope_cos_sin(positions, d_head, theta))`` here: every layer of
a forward rotates by the same angles, so the forward computes them once."""
from __future__ import annotations

import torch


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta**exponent)  # (d_head/2,)


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float = 10000.0):
    """(cos, sin), each (..., S, 1, d_head/2) f32, for ``positions`` (..., S)."""
    freqs = rope_frequencies(d_head, theta, device=positions.device)
    angles = positions.float()[..., None] * freqs  # (..., S, d/2)
    angles = angles[..., None, :]  # broadcast over heads: (..., S, 1, d/2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, d_head) by precomputed angles (see rope_cos_sin),
    in f32 (f64 for a float64 x)."""
    x1, x2 = torch.chunk(x.to(torch.promote_types(x.dtype, torch.float32)), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
