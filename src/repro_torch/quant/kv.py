"""Per-page-per-head scales of the int8 paged KV cache: the port's copy of
``repro.quant.kv``.

Pool layout (see ``repro_torch.serving.kv_cache``): k/v leaves are
``(..., n_pages, page_size, kv_heads, head_dim)``; the int8 pools add f32
scale leaves ``(..., n_pages, kv_heads)`` — one scale per page per kv head,
shared by every token and head-dim lane of that page.  Per-page scales cost
``4·K`` bytes against ``2·K·hd·P`` of int8 payload.

Scale lifecycle (kept by kv_cache): a page's scale only grows while the
page is live (scatter-max on write; the page's bytes are requantized when
it grows) and is zeroed when the page is invalidated.  Scales are indexed
by the same physical page id as the payload, so prefix sharing, eviction
and re-admission move both or neither.

The arithmetic is the reference's, in its order (``x / max(scale, eps)``,
round half to even, clip to ±127), so the bytes come out identical.
"""
from __future__ import annotations

import torch

from repro_torch.quant.core import _EPS, INT8_MAX, int8_scale


def abs_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-page-per-head absmax/127 scales for a ``(..., P, K, hd)`` pool.

    Reduces the page (token) and head-dim axes, returning ``(..., K)``."""
    return int8_scale(x.float().abs().amax(dim=(-3, -1)))


def quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round ``(..., P, K, hd)`` values to int8 using ``(..., K)`` scales."""
    s = scale.clamp(min=_EPS)[..., None, :, None]
    q = torch.round(x.float() / s)
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


def pack_kv(k: torch.Tensor, v: torch.Tensor):
    """Quantize k/v pools ``(..., N, P, K, hd)`` to int8 + per-page scales.

    Returns ``(k_q, v_q, k_scale, v_scale)`` with scales ``(..., N, K)``."""
    k_scale = abs_scale(k)
    v_scale = abs_scale(v)
    return quantize_with(k, k_scale), quantize_with(v, v_scale), k_scale, v_scale


def unpack_kv(k_q, v_q, k_scale, v_scale):
    """Dequantize int8 pools back to f32 (the plain view)."""
    k = k_q.float() * k_scale[..., None, :, None]
    v = v_q.float() * v_scale[..., None, :, None]
    return k, v
