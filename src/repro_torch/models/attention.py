"""Attention: GQA, causal and sliding-window masks, softcap, muP 1/d scale,
position-tagged cache.

The plain path of the port's full-sequence attention (the reference leaves
it to XLA, the port to PyTorch matmul + softmax): one (S, T) logit matrix
for short sequences, query chunks of ``cfg.attn_chunk`` for long ones
(``attend_chunked``; for sliding-window layers each chunk reads only its
band of ``chunk + window`` keys).  muP enters through the logit scale (1/d,
Definition 4.1, folded into ``scale``) and the zero-init of the query
projection (App. D.2), both decided at build time in transformer.py.

The cache is position-tagged; a sliding-window layer's is a ring of
``window`` entries indexed by ``position % window``, so a long prefill
keeps only the last ``window`` tokens there.
"""
from __future__ import annotations

from typing import Dict

import torch

NEG_INF = -2.3819763e38  # large negative, safe in bf16/f32


def make_mask(
    q_pos: torch.Tensor,      # (B, S) int — query token positions
    kv_pos: torch.Tensor,     # (B, T) int — key positions; -1 = empty slot
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """(B, S, T) boolean visibility mask: filled entries, at or before the
    query when ``causal``, and fewer than ``window`` positions behind it
    when ``window`` is set."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    mask = k >= 0
    if causal:
        mask = mask & (k <= q)
    if window:
        mask = mask & ((q - k) < window)
    return mask


def attend_chunked(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, K, hd)
    v: torch.Tensor,          # (B, T, K, hd)
    q_pos: torch.Tensor,      # (B, S)
    kv_pos: torch.Tensor,     # (B, T)
    scale: float,
    causal: bool = True,
    window: int = 0,
    attn_softcap: float = 0.0,
    chunk: int = 2048,
) -> torch.Tensor:
    """Query-chunked attention: the (S, T) logit matrix is never made; the
    live logits are (B, H, chunk, band).  For sliding-window layers the kv
    band of a chunk is ``chunk + window`` keys wide (cut where that is
    narrower than T), so a local layer over a long sequence touches
    O(window) keys a chunk.  The band is placed by index, as in the
    reference: key j sits at position j (the engine's prompt padding sits
    past every real query, so no real query sees it).

    Where S is a multiple of the chunk the chunks are the reference's; a
    ragged last chunk (which the reference's scan cannot take) ends the
    loop here, its band clipped to the keys as every band is.
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    bq = min(chunk, S)
    if bq == S:
        return attend(q, k, v, make_mask(q_pos, kv_pos, causal, window),
                      scale, attn_softcap)
    band = min(bq + window, T) if window else T
    banded = bool(window) and band < T
    outs = []
    for s0 in range(0, S, bq):
        qc, qp = q[:, s0:s0 + bq], q_pos[:, s0:s0 + bq]
        if banded:
            # the kv band covering [s0 + bq - band, s0 + bq), clipped to T
            b0 = min(max(s0 + bq - band, 0), T - band)
            kk, vv = k[:, b0:b0 + band], v[:, b0:b0 + band]
            kp = kv_pos[:, b0:b0 + band]
        else:
            kk, vv, kp = k, v, kv_pos
        outs.append(attend(qc, kk, vv, make_mask(qp, kp, causal, window),
                           scale, attn_softcap))
    return torch.cat(outs, dim=1)


def attend(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, K, hd)
    v: torch.Tensor,          # (B, T, K, hd)
    mask: torch.Tensor,       # (B, S, T) bool
    scale: float,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention in f32 (f64 for float64 q); returns (B, S, H,
    hd) in q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    if H % K:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {K}")
    G = H // K
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, K, G, hd).to(acc)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.to(acc)) * scale
    if attn_softcap:
        logits = attn_softcap * torch.tanh(logits / attn_softcap)
    m = mask[:, None, None, :, :]  # (B,1,1,S,T)
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.to(acc))
    return out.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache: {"k": (B,T,K,hd), "v": (B,T,K,hd), "pos": (B,T) int32 (-1 = empty)}
# For windowed layers T is the window (a ring indexed by pos % T); for
# global layers T is the cache length.
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
    windowed: bool = False,
) -> Dict[str, torch.Tensor]:
    """Write each token at cache index = its position (its position modulo
    the cache length for a windowed ring), in place.

    Positions outside the cache are dropped, as the reference's scatter
    drops them (the engine's prompt padding sits at position == length);
    negative positions count from the end, as in the reference.  PyTorch
    has no dropping scatter, so the dropped writes are masked out here.
    """
    T = cache["k"].shape[1]
    idx = positions.long()
    if windowed:
        idx = idx % T
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
    length: int,              # target cache length (window or cache_len)
    dtype,
    windowed: bool = False,
) -> Dict[str, torch.Tensor]:
    B, S, K, hd = k.shape
    cache = init_kv_cache(B, length, K, hd, dtype, k.device)
    if windowed and S > length:
        # a ring keeps only the last `length` tokens
        k, v, positions = k[:, -length:], v[:, -length:], positions[:, -length:]
    return cache_write(cache, k, v, positions, windowed)
