"""Attention: GQA, causal/position masks, muP 1/d scale, position-tagged cache.

The plain path of the port's prefill (the reference leaves it to XLA, the
port to PyTorch matmul + softmax).  muP enters through the logit scale
(1/d, Definition 4.1, folded into ``scale``) and the zero-init of the query
projection (App. D.2), both decided at build time in transformer.py.
"""
from __future__ import annotations

from typing import Dict

import torch

NEG_INF = -2.3819763e38  # large negative, safe in bf16/f32


def make_mask(
    q_pos: torch.Tensor,      # (B, S) int — query token positions
    kv_pos: torch.Tensor,     # (B, T) int — key positions; -1 = empty slot
) -> torch.Tensor:
    """(B, S, T) causal visibility mask (the sliding window comes with the
    windowed blocks)."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    return (k >= 0) & (k <= q)


def attend(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, K, hd)
    v: torch.Tensor,          # (B, T, K, hd)
    mask: torch.Tensor,       # (B, S, T) bool
    scale: float,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention in f32; returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    if H % K:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {K}")
    G = H // K
    qg = q.reshape(B, S, K, G, hd).float()
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if attn_softcap:
        logits = attn_softcap * torch.tanh(logits / attn_softcap)
    m = mask[:, None, None, :, :]  # (B,1,1,S,T)
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache: {"k": (B,T,K,hd), "v": (B,T,K,hd), "pos": (B,T) int32 (-1 = empty)}
# ---------------------------------------------------------------------------


def init_kv_cache(
    batch: int, length: int, n_kv: int, d_head: int, dtype, device
) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, length, n_kv, d_head), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, n_kv, d_head), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def cache_write(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,      # (B, S, K, hd)
    v_new: torch.Tensor,
    positions: torch.Tensor,  # (B, S)
) -> Dict[str, torch.Tensor]:
    """Write each token at cache index = its position, in place.

    Positions outside the cache are dropped, as the reference's scatter
    drops them (the engine's prompt padding sits at position == length);
    negative positions count from the end, as in the reference.  PyTorch
    has no dropping scatter, so the dropped writes are masked out here.
    """
    T = cache["k"].shape[1]
    idx = positions.long()
    idx = torch.where(idx < 0, idx + T, idx)
    b_idx, s_idx = ((idx >= 0) & (idx < T)).nonzero(as_tuple=True)
    t_idx = idx[b_idx, s_idx]
    cache["k"][b_idx, t_idx] = k_new[b_idx, s_idx].to(cache["k"].dtype)
    cache["v"][b_idx, t_idx] = v_new[b_idx, s_idx].to(cache["v"].dtype)
    cache["pos"][b_idx, t_idx] = positions[b_idx, s_idx].to(torch.int32)
    return cache


def cache_from_prefill(
    k: torch.Tensor,          # (B, S, K, hd) — full-sequence keys
    v: torch.Tensor,
    positions: torch.Tensor,  # (B, S)
    length: int,              # target cache length
    dtype,
) -> Dict[str, torch.Tensor]:
    B, S, K, hd = k.shape
    cache = init_kv_cache(B, length, K, hd, dtype, k.device)
    return cache_write(cache, k, v, positions)
